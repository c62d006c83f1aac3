"""Native (C++) host codec: build-on-first-use, loaded via ctypes.

The reference implements its host paths in C (gpujpeg_huffman_cpu_*.c);
this package compiles the same host codec as the JAX reference with the
system compiler and falls back to the NumPy golden implementation when no
compiler is available (``lib() is None``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

from ..runtime import user_cache_dir, verify_private_dir

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "host_codec.cpp")
_LIB = None
_TRIED = False
#: serialises the first call's build and load: a thread that arrives
#: during it waits for the library rather than taking the NumPy path
_LOCK = threading.Lock()

I64 = ctypes.c_int64
PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
PI32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
PI64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    # per-user 0700 cache dir, ownership-verified before loading a .so
    # from it (a world-shared /tmp path would let another local user
    # plant a matching-named library)
    cache_dir = os.environ.get(
        "GPUJPEG_TPU_TORCH_NATIVE_CACHE",
        os.path.join(user_cache_dir(), "native"))
    os.makedirs(cache_dir, mode=0o700, exist_ok=True)
    if not verify_private_dir(cache_dir):
        log.warning("native cache dir %s is not private; "
                    "falling back to NumPy golden path", cache_dir)
        return None
    so_path = os.path.join(cache_dir, f"host_codec_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    cxx = os.environ.get("CXX", "g++")
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [cxx, "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native host codec build failed (%s); "
                    "falling back to NumPy golden path", e)
        return None


def lib():
    """The loaded native library, or None when unavailable. Threads that
    make the first call at once wait for one build and load."""
    global _LIB, _TRIED
    if not _TRIED:
        with _LOCK:
            if not _TRIED:
                _LIB = _load()
                _TRIED = True
    return _LIB


def _load():
    if os.environ.get("GPUJPEG_TPU_TORCH_NO_NATIVE"):
        return None
    so_path = _build()
    if so_path is None:
        return None
    try:
        L = ctypes.CDLL(so_path)
    except OSError as e:
        log.warning("native host codec load failed: %s", e)
        return None

    L.gj_huffman_encode_segments.restype = I64
    L.gj_huffman_encode_segments.argtypes = [
        PI32, I64, PI32, PI32, PI32, I64,
        PI32, PI32, PI32, PI32, I64,
        PU8, I64, PI64]
    L.gj_huffman_decode_segments.restype = None
    L.gj_huffman_decode_segments.argtypes = [
        PU8, I64, PI64, PI64, PI32, PI32, I64,
        PI32, I64, PI32, PI32, PI32, PI32]
    L.gj_scan_split.restype = I64
    L.gj_scan_split.argtypes = [
        PU8, I64, I64, PI64, PI64, I64,
        ctypes.POINTER(ctypes.c_int64)]
    PU32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    L.gj_build_rows.restype = I64
    L.gj_build_rows.argtypes = [PU8, I64, PI64, PI64, I64, PU32, I64]
    L.gj_build_rows_t.restype = I64
    L.gj_build_rows_t.argtypes = [PU8, I64, PI64, PI64, I64, PU32, I64, I64]
    return L


# ---------------------------------------------------------------------------
# NumPy-facing wrappers (shapes/templates match ops.golden)
# ---------------------------------------------------------------------------

def encode_segments_native(plan, coeff_scan: np.ndarray,
                           dc_by_comp, ac_by_comp) -> list[bytes] | None:
    """Drop-in for ops.golden.encode_segments; None if unavailable."""
    L = lib()
    if L is None:
        return None
    n_comp = len(plan.components)
    dc_code = np.zeros((n_comp, 256), np.int32)
    dc_size = np.zeros((n_comp, 256), np.int32)
    ac_code = np.zeros((n_comp, 256), np.int32)
    ac_size = np.zeros((n_comp, 256), np.int32)
    for c in plan.components:
        dc_code[c.index] = dc_by_comp[c.index].ehufco
        dc_size[c.index] = dc_by_comp[c.index].ehufsi
        ac_code[c.index] = ac_by_comp[c.index].ehufco
        ac_size[c.index] = ac_by_comp[c.index].ehufsi

    coeff = np.ascontiguousarray(coeff_scan, np.int32)
    out_cap = int(coeff.shape[0]) * 260 + plan.n_segments * 16 + 64
    out = np.empty(out_cap, np.uint8)
    offs = np.empty(plan.n_segments + 1, np.int64)
    total = L.gj_huffman_encode_segments(
        coeff, coeff.shape[0],
        np.ascontiguousarray(plan.block_comp, np.int32),
        np.ascontiguousarray(plan.seg_block_start, np.int32),
        np.ascontiguousarray(plan.seg_block_count, np.int32),
        plan.n_segments,
        dc_code, dc_size, ac_code, ac_size, n_comp,
        out, out_cap, offs)
    if total < 0:
        return None
    return [out[offs[s]:offs[s + 1]].tobytes()
            for s in range(plan.n_segments)]


def decode_segments_native(plan, scan_data, segments_by_scan,
                           dc_by_comp, ac_by_comp) -> np.ndarray | None:
    """Drop-in for ops.golden.decode_segments; None if unavailable."""
    L = lib()
    if L is None:
        return None
    # concatenate scans, compute per-plan-segment byte ranges
    scan_base = []
    base = 0
    for sd in scan_data:
        scan_base.append(base)
        base += int(np.asarray(sd).size)
    data = (np.concatenate([np.ascontiguousarray(s, np.uint8).reshape(-1)
                            for s in scan_data])
            if base else np.zeros(1, np.uint8))

    S = plan.n_segments
    lo = np.full(S, -1, np.int64)
    hi = np.full(S, -1, np.int64)
    for s in range(S):
        scan_id = int(plan.seg_scan[s])
        seg_idx = int(plan.seg_scan_index[s])
        seg_list = segments_by_scan[scan_id]
        if seg_idx < len(seg_list):
            a, b = seg_list[seg_idx]
            lo[s] = scan_base[scan_id] + a
            hi[s] = scan_base[scan_id] + b

    # stack unique LUTs, map components (same scheme as the device decoder)
    uniq = []
    def idx_of(t):
        for i, u in enumerate(uniq):
            if u is t:
                return i
        uniq.append(t)
        return len(uniq) - 1
    n_comp = len(plan.components)
    dc_tab = np.zeros(max(n_comp, 1), np.int32)
    ac_tab = np.zeros(max(n_comp, 1), np.int32)
    for c in plan.components:
        dc_tab[c.index] = idx_of(dc_by_comp[c.index])
        ac_tab[c.index] = idx_of(ac_by_comp[c.index])
    luts = np.ascontiguousarray(
        np.stack([t.lut16 for t in uniq]), np.int32)

    coeff = np.empty((plan.n_blocks, 64), np.int32)
    L.gj_huffman_decode_segments(
        data, data.size, lo, hi,
        np.ascontiguousarray(plan.seg_block_start, np.int32),
        np.ascontiguousarray(plan.seg_block_count, np.int32), S,
        np.ascontiguousarray(plan.block_comp, np.int32), plan.n_blocks,
        luts, dc_tab, ac_tab, coeff.reshape(-1))
    return coeff
