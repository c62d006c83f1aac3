"""Segment geometry and output compaction of the device encode.

Counterpart of the JAX reference's ``gpujpeg_tpu/ops/huffman_encode.py``.
Of that module the port keeps what the main path reads:
:func:`cap_for_quality`, :func:`build_enc_geometry` (which gives every
segment its RST marker and whether it carries one) and
:func:`compact_segments`, here as torch ops. The reference's vectorised
XLA encoder body is replaced by the kernels of ``ops/entropy.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..plan import CoderPlan
from ..trace import Tracer


@dataclasses.dataclass(frozen=True)
class EncGeometry:
    """Static per-plan arrays for the encoder."""

    block_cls: np.ndarray        # (NB,) component class (0 luma / 1 chroma)
    dc_pred_idx: np.ndarray      # (NB,)
    block_segment: np.ndarray    # (NB,)
    seg_block_start: np.ndarray  # (S,)
    seg_block_count: np.ndarray  # (S,)
    seg_rst_marker: np.ndarray   # (S,) RST byte value 0xD0..0xD7
    seg_has_rst: np.ndarray      # (S,) 1 unless last segment of its scan
    cap_seg_bytes: int           # per-segment region capacity (pre-stuffing)
    cap_out_bytes: int           # per-segment region capacity (post-stuffing)


def cap_for_quality(quality: int) -> int:
    """Per-block compressed-size capacity (bytes) by quality, as the JAX
    reference sizes its tier budgets. Worst legal block is ~209 bytes
    (63 AC * 26 bit + DC); typical Q75 photo blocks are ~4-8 bytes."""
    if quality >= 98:
        return 224
    if quality >= 90:
        return 96
    if quality >= 80:
        return 48
    return 32


def build_enc_geometry(plan: CoderPlan,
                       cap_bytes_per_block: int | None = None) -> EncGeometry:
    if cap_bytes_per_block is None:
        cap_bytes_per_block = cap_for_quality(plan.params.quality)
    scan_nseg = {s.index: s.segment_count for s in plan.scans}
    last_in_scan = np.array(
        [plan.seg_scan_index[i] == scan_nseg[int(plan.seg_scan[i])] - 1
         for i in range(plan.n_segments)], dtype=np.int32)
    cls = np.array([int(plan.components[c].comp_type) for c in plan.block_comp],
                   dtype=np.int32)
    cap = plan.max_seg_block_count * cap_bytes_per_block
    cap = max(64, (cap + 63) // 64 * 64)
    cap_out = cap + cap // 2 + 8
    return EncGeometry(
        block_cls=cls,
        dc_pred_idx=plan.dc_pred_idx,
        block_segment=plan.block_segment,
        seg_block_start=plan.seg_block_start,
        seg_block_count=plan.seg_block_count,
        seg_rst_marker=(0xD0 + plan.seg_scan_index % 8).astype(np.int32),
        seg_has_rst=(1 - last_in_scan),
        cap_seg_bytes=cap,
        cap_out_bytes=cap_out,
    )


#: output bytes gathered at a time by :func:`compact_segments` (whole
#: segments, so a chunk may pass it by one segment's row); the gather's
#: int64 indices take 24 bytes for each of them, so its scratch stays near
#: ``24 * COMPACT_CHUNK_BYTES`` however large the stream
COMPACT_CHUNK_BYTES = 1 << 24


def compact_segments(out: torch.Tensor, out_len: np.ndarray,
                     cap_out: int, tr: Tracer | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Gather the used prefix of every segment row of ``out`` (S, cap_out)
    uint8 into one contiguous stream, on ``out``'s device, and copy it to
    the host, :data:`COMPACT_CHUNK_BYTES` at a time. ``out_len`` is
    already on the host (the one small sync of the encode, as the
    reference's output-size sync, gpujpeg_huffman_gpu_encoder.cu:1158).
    ``tr`` (the call's tracer) gets a span ``gpujpeg.enc.copy_back``
    around each chunk's copy to the host (the wait for its gather
    included), its bytes the chunk's. Returns (bytes, starts) with
    ``starts`` the (S+1,) exclusive prefix of ``out_len``."""
    out_len = np.asarray(out_len, np.int64)
    starts = np.concatenate([[0], np.cumsum(out_len)]).astype(np.int64)
    flat = np.empty(int(starts[-1]), np.uint8)
    rows = out.reshape(-1)
    s0 = 0
    while s0 < len(out_len):
        s1 = int(np.searchsorted(starts, starts[s0] + COMPACT_CHUNK_BYTES,
                                 side="right")) - 1
        s1 = min(max(s1, s0 + 1), len(out_len))
        lo, hi = int(starts[s0]), int(starts[s1])
        if hi > lo:
            seg_start = torch.from_numpy(starts[s0:s1] - lo).to(out.device)
            i = torch.arange(hi - lo, device=out.device, dtype=torch.int64)
            seg = torch.searchsorted(seg_start, i, right=True)
            seg -= 1
            i -= seg_start[seg]
            seg += s0
            seg *= cap_out
            seg += i
            del i
            chunk = rows[seg]
            if tr is not None:
                tr.open("gpujpeg.enc.copy_back")
            flat[lo:hi] = chunk.cpu().numpy()
            if tr is not None:
                tr.close(hi - lo)
        s0 = s1
    return flat, starts
