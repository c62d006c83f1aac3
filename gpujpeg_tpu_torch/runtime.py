"""Runtime services: the per-user cache directory and the kernel build
directory.

The JAX reference also wires JAX's persistent compilation cache here;
the port has no such cache. Its CUDA kernels are compiled once per
source digest into :func:`kernel_build_dir` (``_build.py``), and the
native host codec into :func:`user_cache_dir` (``native/``): both live in
the per-user cache, so an installed package that another user owns
builds and loads its kernels all the same.
"""
from __future__ import annotations

import os
import stat


def user_cache_dir() -> str:
    """Per-user cache root (0700), safe on multi-user hosts."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    path = os.path.join(base, "gpujpeg_tpu_torch")
    os.makedirs(path, mode=0o700, exist_ok=True)
    return path


def verify_private_dir(path: str) -> bool:
    """True when `path` is owned by us and not writable by others —
    guard before loading executable artifacts (.so) from it."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    return not (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


def kernel_build_dir() -> str:
    """Directory (0700) that holds the compiled CUDA kernel library:
    ``GPUJPEG_TPU_TORCH_BUILD_DIR`` if set, else ``kernels`` in
    :func:`user_cache_dir`."""
    path = os.environ.get("GPUJPEG_TPU_TORCH_BUILD_DIR") or os.path.join(
        user_cache_dir(), "kernels")
    os.makedirs(path, mode=0o700, exist_ok=True)
    return path
