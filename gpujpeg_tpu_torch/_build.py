"""Build and load the CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, which is loaded with ctypes.
The library is named by a digest of the sources and the headers they
include (``csrc/*.cuh``) and kept in
:func:`runtime.kernel_build_dir` (the per-user cache), so a second
process reuses it. The first call of :func:`load_kernels` builds it: one
``nvcc`` per source, all started together, then one link (a few seconds
in all); nothing is compiled at import. A lock makes threads that call
it at once wait for one build and share one loaded library; each build
writes its objects and library into a directory of its own and renames
the library into place last, so processes that build the same digest at
once do not clash either.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()`` of its launch. The wrappers in ``ops/`` (and the
tools) call an entry through :func:`launch`, which makes the tensors'
device current for the call (the entries that size their grid by
``cudaGetDevice`` or set a kernel attribute act on the current device),
passes that device's current stream and raises on a non-zero return.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .runtime import kernel_build_dir, verify_private_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "gj_fdct_quant": [_P, _I, _I, _P, _P, _P, _I, _P, _P],
    "gj_huffman_blocks": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    "gj_merge_stuff": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                       _P],
    "gj_huffman_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P],
    "gj_huffman_lanes": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "gj_idct_rgb": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P],
    "gj_preprocess_planes": [_P, _P, _P, _I, _P, _P],
    "gj_fdct_quant_planes": [_P, _P, _I, _P, _I, _P, _P, _P, _P],
    "gj_idct_planes": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P],
    "gj_postprocess_planes": [_P, _P, _P, _P],
    "gj_dct_huffman_blocks": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _P, _P, _P],
    "gj_copy_bytes": [_P, _P, _L, _P],
    "gj_copy_bytes_grid": [_L, _P, _P],
    "gj_destuff_rows": [_P, _L, _P, _I, _I, _P, _P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or CUDA_HOME)")


def compile_library(srcs: list[str], so: str) -> None:
    """Compile ``srcs`` with nvcc, one process each, all started
    together, and link them into the shared library ``so``; raise with
    nvcc's messages if a step fails. The objects and the library are
    written into a directory of this call's own beside ``so``, and the
    library is renamed to ``so`` last (atomic), so that concurrent builds
    of one ``so`` never share a file."""
    nvcc = _nvcc()
    tmp_dir = tempfile.mkdtemp(prefix=os.path.basename(so) + ".",
                               dir=os.path.dirname(so))
    tmp = os.path.join(tmp_dir, os.path.basename(so))
    objs = [os.path.join(tmp_dir, f"{i}.o") for i in range(len(srcs))]

    def run(*args):
        return subprocess.run([nvcc, *NVCC_FLAGS, *args], capture_output=True,
                              text=True, timeout=900)
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            done = list(pool.map(lambda src, o: run("-c", "-o", o, src),
                                 srcs, objs))
        failed = [f"{os.path.basename(s)}:\n{r.stderr}"
                  for s, r in zip(srcs, done) if r.returncode != 0]
        if not failed:
            r = run("-shared", "-o", tmp, *objs)
            if r.returncode != 0:
                failed.append(f"link:\n{r.stderr}")
        if not failed:
            os.replace(tmp, so)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


#: serialises the build and the load of the kernel library in a process
_LOCK = threading.Lock()
_KERNELS: ctypes.CDLL | None = None


def _library_path() -> str:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = kernel_build_dir()
    if not verify_private_dir(out_dir):
        raise RuntimeError(f"kernel build dir {out_dir} is not private")
    so = os.path.join(out_dir, f"gj_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        compile_library(srcs, so)
    return so


def library_path() -> str:
    """Build the kernel library if needed; return its path. Threads that
    call it at once wait for the first one's build."""
    with _LOCK:
        return _library_path()


def bind(lib: ctypes.CDLL, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Set the argument and result types of ``lib``'s C entries ``names``
    (all of :data:`SIGNATURES` by default)."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Threads that make
    the first call at once wait for one build and load and get the same
    library; later calls take no lock."""
    global _KERNELS
    if _KERNELS is None:
        with _LOCK:
            if _KERNELS is None:
                _KERNELS = bind(ctypes.CDLL(_library_path()))
    return _KERNELS


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def launch(name: str, device, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call C entry ``name`` of ``lib`` (the kernel library by default)
    with ``args`` and the current stream of ``device``, a CUDA device,
    with ``device`` made current for the call so that the entry's device
    queries and attributes act on the card that holds the operands; raise
    if the entry reports a launch error."""
    lib = load_kernels() if lib is None else lib
    device = torch.device(device)
    with torch.cuda.device(device):
        err = getattr(lib, name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(name, err)


def query(name: str, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call C entry ``name`` that launches nothing (a host-side query such
    as ``gj_copy_bytes_grid``) with ``args``; raise on a non-zero
    return."""
    lib = load_kernels() if lib is None else lib
    check_launch(name, getattr(lib, name)(*args))
