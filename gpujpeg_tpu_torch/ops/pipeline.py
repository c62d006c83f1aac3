"""Device encode orchestration: raw RGB -> per-scan entropy bytes.

Counterpart of the encode half of the JAX reference's
``gpujpeg_tpu/ops/jax_pipeline.py``. A per-plan :class:`_EncContext`
holds the plan's tables and geometry as tensors on the encoder's device;
:func:`encode_segments_device` uploads the frame and runs

    E1 fdct_quant (ops/dct.py) -> E2 huffman_blocks -> E3 merge_stuff
    (ops/entropy.py) -> compact_segments (ops/huffman_encode.py)

and splits the compacted bytes into scan bodies. On a CUDA device each
stage is a hand-written kernel; on the CPU each runs its plain torch
version.

The reference's TPU machinery has no counterpart: its tier-1/tier-2
capacities and overflow retry (E2 and E3 use worst-case capacities, so
no segment can overflow), the kernel downgrade chain, vmap batching and
16K chunking.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..plan import CoderPlan
from ..tables import device_tables
from .dct import fdct_quant
from .entropy import build_seg_geometry, huffman_blocks, merge_stuff
from .huffman_encode import compact_segments
from .rgbpack import pack_consts, pack_eligible, transform_consts_tensor


def device_eligible(plan: CoderPlan) -> bool:
    """True when the device encode covers this plan: restart markers on,
    interleaved RGB 4:4:4 input at full resolution (``pack_eligible``),
    and the plan's scan order is component-major or Y/Cb/Cr per block
    position (the two orders E1 writes)."""
    if plan.params.restart_interval <= 0 or not pack_eligible(plan):
        return False
    nblk = plan.components[0].block_count
    if plan.params.interleaved:
        order = (np.arange(nblk)[:, None] + nblk * np.arange(3)).reshape(-1)
    else:
        order = np.arange(3 * nblk)
    return np.array_equal(plan.block_plane_idx, order)


class _EncContext:
    """The plan's device operands: tables, DCT operator, per-component
    divisor rows, colour-transform constants and segment geometry."""

    def __init__(self, plan: CoderPlan, quant_zz: dict, huff: dict,
                 device: torch.device):
        if not device_eligible(plan):
            raise NotImplementedError(
                "the device encode covers interleaved RGB 4:4:4 input with "
                "restart markers; other geometries are not ported yet")
        self.plan = plan
        self.device = device
        self.tables = device_tables(quant_zz, huff, device)
        self.qdiv = torch.stack([self.tables.qdiv[c.quant_table_index]
                                 for c in plan.components]).contiguous()
        self.xf = transform_consts_tensor(pack_consts(plan), device)
        self.interleaved = bool(plan.params.interleaved)
        self.geo = build_seg_geometry(plan, device)

    def run(self, rgb: torch.Tensor):
        """(H, W, 3) uint8 on the context's device -> (out, out_len,
        seg_bits, n_ff) of :func:`entropy.merge_stuff`."""
        t, g = self.tables, self.geo
        coeff = fdct_quant(rgb, t.dct, t.bias, self.qdiv, self.xf,
                           self.interleaved)
        words, bits = huffman_blocks(coeff, g.dc_pred, g.block_cls,
                                     t.ac512, t.dc64)
        return merge_stuff(words, bits, g.seg_start, g.seg_count, g.rst,
                           g.has_rst, g.cap_out)


def _enc_context(cache: dict, plan: CoderPlan, quant_zz: dict, huff: dict,
                 device: torch.device) -> _EncContext:
    key = (plan.params, plan.image, str(device))
    ctx = cache.get(key)
    if ctx is None:
        ctx = _EncContext(plan, quant_zz, huff, device)
        cache[key] = ctx
    return ctx


def upload_rgb(raw, plan: CoderPlan, device: torch.device) -> torch.Tensor:
    """Raw interleaved RGB (bytes or a NumPy array) -> (H, W, 3) uint8
    tensor on ``device``."""
    H, W = plan.image.height, plan.image.width
    a = np.frombuffer(raw, np.uint8) if isinstance(
        raw, (bytes, bytearray, memoryview)) else np.asarray(raw, np.uint8)
    return torch.from_numpy(np.ascontiguousarray(a.reshape(H, W, 3))).to(device)


def encode_segments_device(encoder, raw, plan: CoderPlan, quant_zz: dict,
                           huff: dict):
    """Run the device encoder; returns (scan_bodies, seg_sizes_by_scan):
    per scan, the ready-to-emit entropy bytes (RST markers included) and
    the per-segment byte sizes (for APP13 segment-info back-patching)."""
    ctx = _enc_context(encoder._contexts, plan, quant_zz, huff,
                       encoder.device)
    t0 = time.perf_counter()
    rgb = upload_rgb(raw, plan, ctx.device)
    out, out_len, _seg_bits, _n_ff = ctx.run(rgb)
    out_len_h = out_len.cpu().numpy()
    encoder.stats.duration_in_gpu = (time.perf_counter() - t0) * 1e3
    return _split_scan_bodies(plan, ctx, out, out_len_h)


def _split_scan_bodies(plan: CoderPlan, ctx: _EncContext, out: torch.Tensor,
                       out_len_h: np.ndarray):
    flat, starts = compact_segments(out, out_len_h, ctx.geo.cap_out)
    scan_bodies = []
    seg_sizes_by_scan = []
    seg = 0
    for scan in plan.scans:
        n = scan.segment_count
        body = flat[starts[seg]:starts[seg + n]]
        scan_bodies.append(body.tobytes())
        seg_sizes_by_scan.append(out_len_h[seg:seg + n].astype(np.int64))
        seg += n
    return scan_bodies, seg_sizes_by_scan
