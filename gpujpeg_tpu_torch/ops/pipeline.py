"""Device encode and decode orchestration.

Counterpart of the JAX reference's ``gpujpeg_tpu/ops/jax_pipeline.py``.

**Encode** (raw frame -> per-scan entropy bytes): a per-plan
:class:`EncContext` holds the plan's tables and geometry as tensors on
the encoder's device; :func:`encode_segments_device` uploads the frame
and takes one of two routes:

* interleaved RGB 4:4:4 input at full resolution (``rgbpack.
  pack_eligible``), the main path:

      E1 fdct_quant (ops/dct.py) -> E2 huffman_blocks -> E3 merge_stuff
      (ops/entropy.py) -> compact_segments (ops/huffman_encode.py)

* every other plan with restart markers (all 8 pixel formats, any
  sampling, interleaved or not, 1/3/4 components, any colour pair):

      E0 preprocess_planes (ops/preprocess.py) -> E1p fdct_quant_planes
      (ops/dct.py) -> E2 -> E3 -> compact_segments

and splits the compacted bytes into scan bodies
(:func:`stream.writer.scan_bodies`). E2 and E3 take any segment
geometry, so they stand for the reference's K6 entropy half, K7 and the
``merge_and_stuff`` dispatch (K8-K11) on the second route.

**Decode** (entropy bytes -> raw frame; the reference's
``_decode_device_v2``): a per-(plan, output, tables) :class:`DecContext`
holds the decode tables, IDCT operators and geometry on the decoder's
device. For a stream with restart markers :func:`decode_device`
computes each segment's range in the scans on the host, uploads the
scans' bytes as they lie in the stream with the ranges, and D0
destuff_rows (ops/decode.py) builds the destuffed segment rows on the
card for D1 huffman_decode, the counterpart of K2's Huffman half, K4 and
K5. A stream without restart markers (each scan one segment) has its
rows built on the host (the lanes' geometry needs their lengths) and
takes D1L huffman_lanes, which cuts each scan into lanes of bits that
decode at once (:func:`decode.lane_eligible`). Then one of two routes:

* three full-resolution components decoded to interleaved RGB
  (:func:`decode_eligible`; the reference's px branch):

      D0 -> D1 -> D2 idct_rgb (ops/dct.py)

* every other plan and output (any sampling, interleaved or not, 1/3/4
  components, all 8 pixel formats, any colour pair; the reference's
  plan tail: the scan reorder, ``dequant_idct_device``,
  ``blocks_to_plane`` and ``postprocess``):

      D0 -> D1 (or D1L) -> D2p idct_planes (ops/dct.py) -> D3
      postprocess_planes (ops/preprocess.py)

On a CUDA device each stage is a hand-written kernel; on the CPU each
runs its plain torch version.

**The seam.** Every coder runs a frame's device steps through this
module: ``Encoder`` and ``Decoder`` (``models/``), and the band coders
of ``parallel/``, which run :class:`EncContext` and
:func:`decode_launch` band by band. Nothing here knows a coder: each
function takes what it uses (a context cache, a device, a tracer, a
staging ring, a ``to_host`` flag) and returns what it measured, the
stats by their names, which the coder writes into its own ``stats``.

**Batches.** :func:`encode_batch_device` (``Encoder.encode_batch``)
queues up to ``depth`` frames' uploads and kernels on the current
stream before it brings back the oldest frame: its ``out_len`` comes
back into pinned memory without blocking, and its compaction gather and
copy back run on a side stream, so they do not queue behind the later
frames' kernels. Host frames go to the card through a
:class:`PinnedRing` of ``depth + 1`` pinned buffers with ``non_blocking``
copies. The decode is split for ``Decoder.decode_batch`` into
:func:`decode_prep` (the context and the segments' ranges, or the lane
route's rows, on the host),
:func:`decode_launch` (upload through a :class:`PinnedRing`, the
kernels, and the frame's copy back into pinned memory, without a
sync) and :func:`decode_collect` (the wait on the frame's event). On
the CPU there is no stream and no pinned memory and the same code runs
frame after frame. The single-frame :func:`encode_segments_device` and
:func:`decode_device` keep their pageable uploads (the decode's, a copy
a scan and one for the ranges: a pinned block of the context's own
measured no faster inside the benchmark's loop, PERF.md §6).

**Decoded frames in host memory.** A frame that a decode brings back
from the card (``Decoder.decode``'s :func:`copy_back`, a batch's
:func:`decode_launch`) lands in a block of page-locked memory from
torch's caching host allocator (:func:`pinned_like`). The block belongs
to the returned tensor, and to the NumPy array that views it, as long as
the caller holds either; no later decode writes into it. When the caller
drops the frame the block returns to the cache, and the next frame of
that size takes it without a page fault or a ``cudaHostAlloc``. A caller
that holds many frames holds that much page-locked memory.

**Stage statistics and spans.** With ``Parameters.perf_stats`` (encode)
or ``Decoder.perf_stats`` (decode) the call's :class:`trace.Tracer`
opens a span around each host step of :func:`encode_segments_device`
and :func:`decode_device` (the context, the upload or the ranges (the
lane route's row build) and their upload, the kernels' enqueue, the
wait, the copy back) and marks the stage boundaries on the device: on
the card a CUDA event recorded on the stream between two launches, read
after the one sync at the end; on the CPU the host clock. The encode
times ``duration_memory_to`` (upload), ``duration_preprocessor`` (E0; 0
on the E1 route, whose colour transform is inside E1),
``duration_dct_quantization`` (E1 or E1p), ``duration_huffman_coder``
(E2 + E3) and ``duration_memory_from`` (compaction and copy back); the
decode ``duration_huffman_coder`` (D0 + D1, or D1L),
``duration_dct_quantization`` (D2 or D2p) and ``duration_postprocessor``
(D3; 0 on the D2 route). Without it no span is opened, no event is
recorded and nothing more is synced. The batch paths get no span of
their own: ``Encoder.encode_batch`` and ``Decoder.decode_batch`` are one
root span each.

The reference's TPU machinery has no counterpart, and why:

* its tier-1/tier-2 capacities with the overflow retry, and the W/bps
  power-of-two dispatch between its merge kernels: E2 and E3 size every
  block and segment for the worst case, so nothing can overflow and one
  kernel serves every geometry;
* the kernel downgrade chain (``jax_pipeline.py:633-672``): a fallback
  that hides a kernel's failure; here a kernel that fails to build or
  launch raises;
* 16K chunking (``jax_pipeline.py:492-583``), written for a 16 GB chip:
  per block the port holds 256 B of coefficients, 224 B of E2 scratch,
  4 B of bit length and at most 448 B of E3 output, about 0.93 KB, so a
  16K 4:4:4 frame of 6.2M blocks needs about 5.8 GB of the H100's 80 GB
  (``Encoder.max_memory``);
* vmap batching of B frames into one launch (``_batch_frames_auto``,
  ``GPUJPEG_TPU_BATCH_FRAMES``, ``batched_fn``, and the decoder's
  ``_fuse_frames`` and ``_launch_fused``), which amortised the TPU's
  0.5-1 ms dispatch floor: a batch here launches each kernel once per
  frame, since one frame's kernels already fill the card (an HD 4:4:4
  frame has 97,200 blocks) and a launch costs microseconds;
* the staged executables that its stage statistics
  need (a launch here is already one stage) and XLA fallbacks, and on
  the decode its seg_tile sizing, v2/v3 route (K4 or K5 by ``wcap``),
  wcap buckets and slot templates: D1 takes any row width and block
  map.
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

import numpy as np
import torch

from ..plan import CoderPlan
from ..stream.writer import scan_bodies
from ..tables import decode_device_tables, device_tables
from ..trace import Tracer
from .dct import fdct_quant, fdct_quant_planes, idct_planes, idct_rgb
from .decode import (
    ScanBytes, build_dec_tables_v2, build_rows, check_cover, destuff_rows,
    huffman_decode, huffman_lanes, lane_eligible, lane_geometry,
    lane_segments, quant_slots, scan_bytes, table_slots, wide_quick_tables)
from .entropy import build_seg_geometry, huffman_blocks, merge_stuff
from .huffman_encode import compact_segments
from .preprocess import (
    block_geometry, out_geometry, plane_geometry, postprocess_planes,
    preprocess_planes, upload_raw)
from .rgbpack import (
    pack_consts, pack_eligible, transform_consts_tensor, unpack_consts,
    unpack_eligible)


def _mark(clock: Tracer | None) -> None:
    if clock is not None:
        clock.mark()


def _scan_order_ok(plan: CoderPlan) -> bool:
    """True when the plan's scan order is component-major or Y/Cb/Cr per
    block position (the two orders E1 writes and D2 reads)."""
    nblk = plan.components[0].block_count
    if plan.params.interleaved:
        order = (np.arange(nblk)[:, None] + nblk * np.arange(3)).reshape(-1)
    else:
        order = np.arange(3 * nblk)
    return np.array_equal(plan.block_plane_idx, order)


def rgb_eligible(plan: CoderPlan) -> bool:
    """True when the encode takes the E1 route: interleaved RGB 4:4:4
    input at full resolution (``pack_eligible``) and one of the two scan
    orders of :func:`_scan_order_ok`. Every other plan takes E0 + E1p."""
    return pack_eligible(plan) and _scan_order_ok(plan)


def decode_eligible(plan: CoderPlan, out_image) -> bool:
    """True when the device decode takes the D2 route: restart markers
    on, three full-resolution components, 4:4:4 interleaved RGB output
    with an expressible inverse transform (``unpack_eligible``), and one
    of the two scan orders of :func:`_scan_order_ok`. Every other plan
    and output takes D2p + D3."""
    return (plan.params.restart_interval > 0
            and unpack_eligible(plan, out_image) and _scan_order_ok(plan))


def _flat_bytes(a: np.ndarray) -> np.ndarray:
    """A host array's bytes, a flat uint8 view (a copy where it is not
    contiguous)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _fill(buf: torch.Tensor, parts) -> None:
    """Copy each (host array, byte offset) pair's bytes into ``buf``, a
    flat uint8 host tensor, at its offset, by NumPy on this thread (a
    torch copy between host tensors may run on torch's thread pool: an
    8K decode's upload took 2-3 ms so in the benchmark's loop, PERF.md
    §6)."""
    dst = buf.numpy()
    for a, off in parts:
        a = _flat_bytes(a)
        dst[off:off + a.size] = a


def upload_parts(parts, total: int, device: torch.device,
                 staging: "PinnedRing | None" = None) -> torch.Tensor:
    """(host array, byte offset) pairs -> one flat uint8 tensor of
    ``total`` bytes on ``device`` holding each array's bytes at its
    offset (the bytes between parts unset): through ``staging`` (on the
    card) in one copy that does not block the host, else a pageable copy
    a part."""
    if staging is not None:
        return staging.upload_parts(parts, total, device)
    dev = torch.empty(total, dtype=torch.uint8, device=device)
    for a, off in parts:
        dev[off:off + a.nbytes].copy_(torch.from_numpy(_flat_bytes(a)))
    return dev


class PinnedRing:
    """A ring of pinned host buffers that carries host arrays to the card
    for the batch paths: each array is copied into the next slot and sent
    with a ``non_blocking`` copy on the current stream. A slot is refilled only after the event
    recorded behind its last copy has completed, so no buffer is
    overwritten under a copy in flight. A slot grows to the largest
    upload it has carried (a quarter more where it grows) and is kept."""

    def __init__(self, slots: int):
        self.bufs: list = [None] * slots
        self.events: list = [None] * slots
        self.next = 0

    def upload(self, a: np.ndarray, device: torch.device) -> torch.Tensor:
        """Host array -> a flat uint8 tensor of its bytes on ``device`` (a
        CUDA device), queued without blocking the host."""
        src = torch.from_numpy(_flat_bytes(a))
        k, host = self._slot(src.numel())
        host.copy_(src)
        return self._send(k, host, device)

    def upload_parts(self, parts, total: int,
                     device: torch.device) -> torch.Tensor:
        """(host array, byte offset) pairs -> one flat uint8 tensor of
        ``total`` bytes on ``device`` (a CUDA device) that holds each
        array's bytes at its offset (:func:`_fill`), sent in one copy
        queued without blocking the host (the bytes between parts are
        unset)."""
        k, host = self._slot(total)
        _fill(host, parts)
        return self._send(k, host, device)

    def _slot(self, total: int) -> tuple:
        """(index, pinned buffer cut to ``total`` bytes) of the next slot,
        once its last copy has run; a slot too small grows, with a quarter
        to spare (frames of one geometry differ by a little, and each
        growth is a fresh page-locked allocation)."""
        k = self.next
        self.next = (k + 1) % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
        if self.bufs[k] is None or self.bufs[k].numel() < total:
            grown = 0 if self.bufs[k] is None else self.bufs[k].numel()
            self.bufs[k] = torch.empty(max(total, grown * 5 // 4),
                                       dtype=torch.uint8, pin_memory=True)
        return k, self.bufs[k][:total]

    def _send(self, k: int, host: torch.Tensor,
              device: torch.device) -> torch.Tensor:
        """Slot ``k``'s filled ``host`` bytes to ``device`` without
        blocking, the slot's event recorded behind the copy."""
        dev = torch.empty(host.numel(), dtype=torch.uint8, device=device)
        dev.copy_(host, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record(torch.cuda.current_stream(device))
        return dev

    def wait(self) -> None:
        """Block until every slot's last copy has completed."""
        for ev in self.events:
            if ev is not None:
                ev.synchronize()


class EncContext:
    """The plan's device operands: tables, DCT operator, per-component
    divisor rows, colour-transform constants, plane geometry and segment
    geometry."""

    def __init__(self, plan: CoderPlan, quant_zz: dict, huff: dict,
                 device: torch.device):
        if plan.params.restart_interval <= 0:
            raise ValueError("the device encode needs restart markers "
                             "(restart_interval > 0)")
        self.plan = plan
        self.device = device
        self.tables = device_tables(quant_zz, huff, device)
        self.qdiv = torch.stack([self.tables.qdiv[c.quant_table_index]
                                 for c in plan.components]).contiguous()
        self.geo = build_seg_geometry(plan, device)
        self.planes = plane_geometry(plan, device)
        self.rgb_route = rgb_eligible(plan)
        self.interleaved = bool(plan.params.interleaved)
        if self.rgb_route:
            self.xf = transform_consts_tensor(pack_consts(plan), device)

    def upload(self, raw, staging: PinnedRing | None = None
               ) -> torch.Tensor:
        """Raw frame (bytes, a NumPy array or a tensor) -> what
        :meth:`run` takes: (H, W, 3) uint8 on the E1 route, the flat bytes
        otherwise; host bytes go through ``staging`` when given."""
        if self.rgb_route:
            return upload_rgb(raw, self.plan, self.device, staging)
        return upload_raw(raw, self.plan.image, self.device, staging)

    def run(self, x: torch.Tensor, clock: Tracer | None = None,
            rst: torch.Tensor | None = None,
            has_rst: torch.Tensor | None = None):
        """:meth:`upload`'s tensor -> (out, out_len, seg_bits, n_ff) of
        :func:`entropy.merge_stuff`; ``clock`` is marked after the
        preprocessor, the DCT and the Huffman stage. ``rst`` and
        ``has_rst`` (see :meth:`entropy`) replace the plan's markers."""
        coeff = self.coefficients(x, clock)
        _mark(clock)
        out = self.entropy(coeff, rst, has_rst)
        _mark(clock)
        return out

    def coefficients(self, x: torch.Tensor,
                     clock: Tracer | None = None) -> torch.Tensor:
        """:meth:`upload`'s tensor -> (NB, 64) int32 scan-order
        coefficients, by E1 or by E0 + E1p (``clock`` marked between the
        two, or before E1)."""
        if self.rgb_route:
            _mark(clock)
            t = self.tables
            return fdct_quant(x, t.dct, t.bias, self.qdiv, self.xf,
                              self.interleaved)
        return self.coefficients_planes(x, clock)

    def coefficients_planes(self, raw: torch.Tensor,
                            clock: Tracer | None = None
                            ) -> torch.Tensor:
        """Flat raw bytes (:func:`preprocess.upload_raw`) -> scan-order
        coefficients by E0 + E1p, for any plan."""
        t, g = self.tables, self.planes
        planes = preprocess_planes(raw, g)
        _mark(clock)
        return fdct_quant_planes(planes, t.dct, t.bias, self.qdiv, g.blk,
                                 g.block_plane_idx)

    def entropy(self, coeff: torch.Tensor,
                rst: torch.Tensor | None = None,
                has_rst: torch.Tensor | None = None):
        """Scan-order coefficients -> E2 -> E3. ``rst`` and ``has_rst``,
        (S,) int32 on the context's device, give each segment's marker
        and whether it carries one in place of the plan's own: a band of
        a sharded frame numbers its markers in the whole frame's scans
        (``parallel.sharded``), on a context it shares with every band of
        its geometry and device."""
        t, g = self.tables, self.geo
        words, bits = huffman_blocks(coeff, g.dc_pred, g.block_cls,
                                     t.ac512, t.dc64)
        return merge_stuff(words, bits, g.seg_start, g.seg_count,
                           g.rst if rst is None else rst,
                           g.has_rst if has_rst is None else has_rst,
                           g.cap_out)

    def compact(self, out: torch.Tensor, out_len_h: np.ndarray):
        """E3's (S, cap_out) rows and their (S,) lengths in host memory ->
        a band of :func:`stream.writer.scan_bodies`: (the segments' bytes
        back to back in host memory, ``out_len_h``)."""
        flat, _ = compact_segments(out, out_len_h, self.geo.cap_out)
        return flat, out_len_h


def enc_context(cache: dict, plan: CoderPlan, quant_zz: dict, huff: dict,
                device: torch.device) -> EncContext:
    """The encode context of (plan, device) in ``cache``, built there on
    its first use."""
    key = (plan.params, plan.image, str(device))
    ctx = cache.get(key)
    if ctx is None:
        ctx = EncContext(plan, quant_zz, huff, device)
        cache[key] = ctx
    return ctx


def upload_rgb(raw, plan: CoderPlan, device: torch.device,
               staging: PinnedRing | None = None) -> torch.Tensor:
    """Raw interleaved RGB (bytes, a NumPy array or a uint8 or int32
    tensor) -> (H, W, 3) uint8 tensor on ``device``, by
    :func:`preprocess.upload_raw` (its checks; a tensor on ``device`` is
    not copied)."""
    H, W = plan.image.height, plan.image.width
    return upload_raw(raw, plan.image, device, staging).view(H, W, 3)


#: the encode's stats that its tracer's marks time, in mark order
ENC_MARKED = ("duration_memory_to", "duration_preprocessor",
              "duration_dct_quantization", "duration_huffman_coder",
              "duration_memory_from")


def encode_segments_device(contexts: dict, device: torch.device, raw,
                           plan: CoderPlan, quant_zz: dict, huff: dict,
                           tr: Tracer | None = None):
    """Run the device encode on ``device``, its context kept in
    ``contexts``; returns (scan_bodies, seg_sizes_by_scan, timed): per
    scan, the ready-to-emit entropy bytes (RST markers included) and the
    per-segment byte sizes (for APP13 segment-info back-patching), and
    the encoder stats it measured, by name: ``duration_in_gpu`` (upload,
    kernels and the lengths' sync, ms) and, with ``tr`` (the call's
    tracer with perf stats on, which gets the spans and marks), the
    stage durations of :data:`ENC_MARKED`."""
    if tr is not None:
        tr.open("gpujpeg.enc.context")
    ctx = enc_context(contexts, plan, quant_zz, huff, device)
    if tr is not None:
        tr.close()
        t0 = tr.open("gpujpeg.enc.upload")
        tr.mark()
    else:
        t0 = time.perf_counter_ns()
    x = ctx.upload(raw)
    if tr is not None:
        tr.mark()
        tr.close(0 if isinstance(raw, torch.Tensor)
                 and raw.device == x.device else x.nbytes)
        tr.open("gpujpeg.enc.launch")
    out, out_len, _seg_bits, _n_ff = ctx.run(x, tr)
    if tr is not None:
        tr.close()
        tr.open("gpujpeg.enc.wait")
    out_len_h = out_len.cpu().numpy()
    t1 = tr.close() if tr is not None else time.perf_counter_ns()
    timed = {"duration_in_gpu": (t1 - t0) * 1e-6}
    if tr is not None:
        tr.open("gpujpeg.enc.memory_from")
    bodies, sizes = scan_bodies(plan, [ctx.compact(out, out_len_h)])
    if tr is not None:
        tr.mark()
        tr.close(sum(map(len, bodies)))
        timed.update(zip(ENC_MARKED, tr.durations()))
    return bodies, sizes, timed


def encode_batch_device(contexts: dict, device: torch.device, raws,
                        plan: CoderPlan, quant_zz: dict, huff: dict,
                        depth: int = 3):
    """Pipelined encode of same-geometry frames (the reference's
    ``jax_pipeline.encode_batch_device``): up to ``depth`` frames' uploads
    and kernels (one launch of each kernel a frame) are queued on the
    current stream before the oldest frame is brought back, so its copy
    back, compaction and the caller's stream assembly run under the later
    frames' kernels. Yields one (scan_bodies, seg_sizes_by_scan) of
    :func:`encode_segments_device` a frame, in order. On the card host
    frames go through a :class:`PinnedRing` of ``depth + 1`` buffers, each
    frame's ``out_len`` comes back into pinned memory behind an event,
    and the compaction gather runs on a side stream that waits on that
    event (``out`` is recorded on it), so it does not queue behind frames
    ``i+1 .. i+depth``. Stage statistics are not recorded."""
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    ctx = enc_context(contexts, plan, quant_zz, huff, device)
    cuda = ctx.device.type == "cuda"
    staging = PinnedRing(depth + 1) if cuda else None
    side = torch.cuda.Stream(ctx.device) if cuda else None
    pending: collections.deque = collections.deque()

    def collect():
        out, out_len, ev = pending.popleft()
        if ev is None:
            return scan_bodies(plan, [ctx.compact(out, out_len.numpy())])
        ev.synchronize()
        with torch.cuda.stream(side):
            side.wait_event(ev)
            out.record_stream(side)
            return scan_bodies(plan, [ctx.compact(out, out_len.numpy())])

    try:
        for raw in raws:
            out, out_len, _seg_bits, _n_ff = ctx.run(ctx.upload(raw,
                                                                staging))
            ev = None
            if cuda:
                host = torch.empty(out_len.shape, dtype=out_len.dtype,
                                   pin_memory=True)
                host.copy_(out_len, non_blocking=True)
                out_len, ev = host, torch.cuda.Event()
                ev.record(torch.cuda.current_stream(ctx.device))
            pending.append((out, out_len, ev))
            if len(pending) >= depth:
                yield collect()
        while pending:
            yield collect()
    finally:
        if staging is not None:
            staging.wait()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

#: decode contexts kept per decoder (one per recent geometry and table set)
DEC_CONTEXTS = 4
#: the key of ``torch.cuda.host_memory_stats()`` that counts, over the
#: process, the bytes of the page-locked blocks that torch's caching host
#: allocator took from CUDA (each rounded up to a power of two); a cached
#: block handed out again adds nothing (torch 2.11; a torch upgrade
#: re-checks it: ``tests/test_torch_copy_back.py`` on the card)
PINNED_TAKEN = "allocated_bytes.allocated"


class DeviceScan(NamedTuple):
    """:class:`decode.ScanBytes` on the device: what D0 builds the rows
    from (:func:`decode.destuff_rows`)."""
    data: torch.Tensor            # (N,) uint8: the scans laid end to end
    ranges: torch.Tensor          # (2, S) int32: each segment's lo, hi
    wcap: int                     # the rows' width in words

    @property
    def device(self) -> torch.device:
        return self.data.device


def upload_scan(x: ScanBytes, device: torch.device,
                staging: PinnedRing | None = None) -> DeviceScan:
    """:func:`decode.scan_bytes`' host half -> the same on ``device``, in
    one buffer laid out by :meth:`decode.ScanBytes.parts`
    (:func:`upload_parts`)."""
    parts, total = x.parts()
    buf = upload_parts(parts, total, device, staging)
    r0 = parts[-1][1]
    return DeviceScan(buf[:x.n_data], buf[r0:].view(torch.int32).view(
        x.ranges.shape), x.wcap)


class DecContext:
    """The decode operands of one plan, output and table set: tables,
    IDCT operators and segment geometry (for a plan without restart
    markers, the lane route's segments and its last rows' lane
    geometry), then the D2
    route's inverse-transform constants or the plan tail's block and
    output geometry.

    A frame's decode: :meth:`prep` on the host, :meth:`upload`, then
    :meth:`run`. On the card route (every plan off the lane route) the
    host computes only the segments' ranges, the scans' bytes go up as
    they lie in the stream and D0 builds the rows on the device before
    D1; on the lane route the host builds the rows (:meth:`rows`), whose
    destuffed lengths the lane geometry needs before the launch. Which
    route a frame takes is the plan's alone."""

    def __init__(self, plan: CoderPlan, out_image, tables,
                 device: torch.device):
        self.plan = plan
        self.device = device
        self.tables = tables

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        # D1 writes only the blocks of its segments
        check_cover(plan.seg_block_start, plan.seg_block_count,
                    len(plan.block_comp))
        self.seg_start = t(plan.seg_block_start)
        self.seg_count = t(plan.seg_block_count)
        self.block_comp = t(plan.block_comp)
        self.n_blocks = len(plan.block_comp)
        #: the lane route (D1L): each scan one segment, no restart markers
        self.lanes = lane_eligible(plan)
        if self.lanes:
            self.lane_segs = lane_segments(plan)
            #: the lane geometry of the rows that :meth:`rows` built last
            self.geo = None
            #: the last lane decode's rounds (a device tensor), and in
            #: host memory once :meth:`run` traced it
            self.rounds, self._rounds_host = None, None
        self.rgb_route = decode_eligible(plan, out_image)
        if self.rgb_route:
            self.xf = transform_consts_tensor(
                unpack_consts(plan, out_image), device)
            self.interleaved = bool(plan.params.interleaved)
            self.shape = (plan.image.height, plan.image.width)
        else:
            self.blocks = block_geometry(plan, device)
            self.out = out_geometry(plan, out_image, device)

    def rows(self, scan_data, segments_by_scan) -> np.ndarray:
        """The plan's (S, wcap) int32 segment rows (:func:`build_rows`); on
        the lane route also their lane geometry, whose lanes cover each
        segment's data and not the zero words past it."""
        if not self.lanes:
            return build_rows(self.plan, scan_data, segments_by_scan)
        words = np.zeros(self.plan.n_segments, np.int64)
        rows = build_rows(self.plan, scan_data, segments_by_scan, words)
        self.geo = lane_geometry(self.lane_segs, words * 32)
        return rows

    def prep(self, scan_data, segments_by_scan):
        """The host half of a frame's decode: on the lane route the
        plan's rows (:meth:`rows`), else the scans' bytes and the
        segments' ranges (:func:`decode.scan_bytes`), from which D0 builds
        the rows on the device."""
        if self.lanes:
            return self.rows(scan_data, segments_by_scan)
        return scan_bytes(self.plan, scan_data, segments_by_scan)

    def upload(self, x, staging: PinnedRing | None = None):
        """:meth:`prep`'s host half on the context's device: rows (an
        (S, wcap) int32 array, :meth:`rows`') as the same rows, a
        :class:`decode.ScanBytes` as a :class:`DeviceScan`
        (:func:`upload_scan`); pageable, or through ``staging`` (on the
        card) without blocking the host."""
        if isinstance(x, ScanBytes):
            return upload_scan(x, self.device, staging)
        if staging is None:
            return torch.from_numpy(x).to(self.device)
        return staging.upload(x, self.device).view(torch.int32).view(
            x.shape)

    def coefficients(self, rows: torch.Tensor) -> torch.Tensor:
        """(S, wcap) int32 rows -> (NB, 64) int32 scan-order coefficients
        by D1, or on the lane route by D1L over the lane geometry of the
        rows that :meth:`rows` built last (another frame's of the plan
        gives the same coefficients, in other rounds)."""
        t = self.tables
        if not self.lanes:
            return huffman_decode(rows, self.seg_start, self.seg_count,
                                  self.block_comp, t.wide, t.maxcode,
                                  t.delta, t.huffval, t.dc_slot, t.ac_slot)
        if self.geo is None:
            raise ValueError("the lane route decodes rows that "
                             "DecContext.rows built")
        out, self.rounds = huffman_lanes(rows, self.geo, self.n_blocks,
                                         t.wide, t.maxcode, t.delta,
                                         t.huffval, t.dc_slot, t.ac_slot)
        return out

    def lane_rounds(self) -> int:
        """The rounds of the last lane decode that :meth:`run` traced; on
        the card read after the decode's sync, from the pinned copy that
        :meth:`run` queued behind the kernels."""
        return int(self._rounds_host[0])

    def pixels(self, coeff: torch.Tensor,
               clock: Tracer | None = None) -> torch.Tensor:
        """Scan-order coefficients -> the flat uint8 raw frame, by D2 or
        by D2p + D3 (``clock`` marked between the two, or after D2)."""
        t = self.tables
        if self.rgb_route:
            raw = idct_rgb(coeff, t.quant, t.q_of, self.xf,
                           self.interleaved, *self.shape).view(-1)
            _mark(clock)
            return raw
        b = self.blocks
        planes = idct_planes(coeff, t.quant, t.q_of, b.blk,
                             b.block_plane_idx, b.total)
        _mark(clock)
        return postprocess_planes(planes, self.out)

    def run(self, x, clock: Tracer | None = None) -> torch.Tensor:
        """:meth:`upload`'s result (a :class:`DeviceScan`, or (S, wcap)
        int32 rows) on the context's device -> the flat uint8 raw frame;
        from a :class:`DeviceScan` D0 builds the rows first. ``clock`` is
        marked after D1 (or D0 + D1, or D1L), the IDCT stage and D3. On
        the lane route ``clock`` gets the span ``gpujpeg.dec.lanes``
        around D1L's enqueue (its count the lanes) and the rounds are
        copied to host memory behind the kernels (:meth:`lane_rounds`)."""
        rows = x
        if isinstance(x, DeviceScan):
            rows = destuff_rows(x.data, x.ranges, x.wcap)
        if self.lanes and clock is not None:
            clock.open("gpujpeg.dec.lanes")
            coeff = self.coefficients(rows)
            clock.close(int(self.geo[1]))
            if self.device.type == "cuda":
                if self._rounds_host is None:
                    self._rounds_host = torch.empty(1, dtype=torch.int32,
                                                    pin_memory=True)
                self._rounds_host.copy_(self.rounds, non_blocking=True)
            else:
                self._rounds_host = self.rounds
        else:
            coeff = self.coefficients(rows)
        _mark(clock)
        raw = self.pixels(coeff, clock)
        _mark(clock)
        return raw


def dec_context(cache: dict, plan: CoderPlan, info, dc_by_comp, ac_by_comp,
                out_image, device: torch.device,
                limit: int = DEC_CONTEXTS) -> DecContext:
    """The cached decode context of (plan, output, tables, device); at
    most ``limit`` are kept, the oldest dropped first."""
    uniq, dc_slot, ac_slot = table_slots(plan, dc_by_comp, ac_by_comp)
    tabs = build_dec_tables_v2(uniq)
    qts, q_of = quant_slots(plan, info)
    key = (plan.params, plan.image, out_image, str(device), qts,
           q_of.tobytes(), dc_slot.tobytes(), ac_slot.tobytes(),
           tabs.quick.tobytes(), tabs.maxcode.tobytes(),
           tabs.delta.tobytes(), tabs.huffval.tobytes())
    ctx = cache.get(key)
    if ctx is None:
        ctx = DecContext(plan, out_image, decode_device_tables(
            tabs, wide_quick_tables(tabs), dc_slot, ac_slot, qts, q_of,
            device), device)
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = ctx
    return ctx


def decode_prep(contexts: dict, device: torch.device, plan: CoderPlan, info,
                scan_data, segments_by_scan, dc_by_comp, ac_by_comp,
                out_image, tr: Tracer | None = None):
    """The host half of a device decode on ``device``, its context kept in
    ``contexts``: (the decode context, :meth:`DecContext.prep`'s host
    half: the scans' bytes and ranges, or on the lane route the rows);
    ``tr`` gets a span around each, ``gpujpeg.dec.rows`` with the bytes
    that go up."""
    if tr is not None:
        tr.open("gpujpeg.dec.context")
    ctx = dec_context(contexts, plan, info, dc_by_comp, ac_by_comp,
                      out_image, device)
    if tr is not None:
        tr.close()
        tr.open("gpujpeg.dec.rows")
    host = ctx.prep(scan_data, segments_by_scan)
    if tr is not None:
        tr.close(host.nbytes)
    return ctx, host


#: the decoder's stats that its tracer's marks time, in mark order
DEC_MARKED = ("duration_huffman_coder", "duration_dct_quantization",
              "duration_postprocessor")


def decode_device(contexts: dict, device: torch.device, plan: CoderPlan,
                  info, scan_data, segments_by_scan, dc_by_comp, ac_by_comp,
                  out_image, tr: Tracer | None = None):
    """Run the device decode on ``device``, its context kept in
    ``contexts``; returns (the flat uint8 raw frame in the output's pixel
    format on ``device``, ``(fn, args)`` such that ``fn(*args)`` replays
    the kernels (D0 included) on the bytes already on the device and
    returns the same frame, the decoder stats it measured by name:
    ``bytes_memory_to`` (the scans' bytes and ranges, or the lane route's
    rows), ``duration_memory_to`` and ``duration_in_gpu`` and, with
    ``tr`` (the call's tracer with perf stats on, which gets the spans,
    marks and counters: after the wait ``gpujpeg.dec.card_rows``, the
    segments D0 destuffed, or on the lane route ``gpujpeg.dec.rounds``),
    the stage durations of :data:`DEC_MARKED`)."""
    ctx, host = decode_prep(contexts, device, plan, info, scan_data,
                            segments_by_scan, dc_by_comp, ac_by_comp,
                            out_image, tr)
    t0 = (tr.open("gpujpeg.dec.memory_to") if tr is not None
          else time.perf_counter_ns())
    x = ctx.upload(host)
    if tr is not None:
        t1 = tr.close(host.nbytes)
        tr.open("gpujpeg.dec.launch")
        tr.mark()
    else:
        t1 = time.perf_counter_ns()
    raw = ctx.run(x, tr)
    if tr is not None:
        tr.close()
        tr.open("gpujpeg.dec.wait")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t2 = tr.close() if tr is not None else time.perf_counter_ns()
    timed = {"bytes_memory_to": int(host.nbytes),
             "duration_memory_to": (t1 - t0) * 1e-6,
             "duration_in_gpu": (t2 - t1) * 1e-6}
    if tr is not None:
        timed.update(zip(DEC_MARKED, tr.durations()))
        if ctx.lanes:
            tr.count("gpujpeg.dec.rounds", ctx.lane_rounds())
        else:
            tr.count("gpujpeg.dec.card_rows", x.ranges.shape[1])
    return raw, (ctx.run, (x,)), timed


def pinned_like(t: torch.Tensor, tr: Tracer | None = None) -> torch.Tensor:
    """An empty host tensor of ``t``'s shape and dtype in page-locked
    memory from torch's caching host allocator: the block is the
    tensor's until its last reference goes, then returns to the cache for
    the next request of its size. ``tr`` gets the span
    ``gpujpeg.dec.pin``, whose bytes are those the allocator took fresh
    from CUDA for it: 0 where a cached block served it (the count is the
    process's, so another thread's allocation at that moment adds to
    it)."""
    if tr is None:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    tr.open("gpujpeg.dec.pin")
    before = _pinned_taken()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    tr.close(_pinned_taken() - before)
    return host


def _pinned_taken() -> int:
    """The process's count :data:`PINNED_TAKEN`."""
    stats = torch.cuda.host_memory_stats()
    if PINNED_TAKEN not in stats:
        raise KeyError(f"torch {torch.__version__}'s host_memory_stats() "
                       f"has no {PINNED_TAKEN!r}: set PINNED_TAKEN to its "
                       f"count of pinned bytes taken from CUDA")
    return stats[PINNED_TAKEN]


def copy_back(raw: torch.Tensor, tr: Tracer | None = None) -> torch.Tensor:
    """:func:`decode_device`'s frame in host memory, a tensor of the
    caller's own: from the card a copy into :func:`pinned_like`'s block
    (``tr`` gets its span), after the decode's sync; on the CPU ``raw``."""
    if raw.device.type != "cuda":
        return raw
    host = pinned_like(raw, tr)
    host.copy_(raw)
    return host


class Launched(NamedTuple):
    """A batch frame's decode in flight (:func:`decode_launch`)."""
    raw: torch.Tensor             # the flat raw frame, once ``event`` is done
    event: object                 # a CUDA event behind its work, or None
    replay: tuple                 # (fn, args): ``fn(*args)`` reruns its kernels


def decode_launch(ctx: DecContext, host, staging: PinnedRing | None,
                  to_host: bool) -> Launched:
    """The device half of a batch decode, without a sync: the host half
    of :func:`decode_prep` is uploaded (through ``staging`` on the card),
    the kernels launched and, with ``to_host``, the frame's copy back
    queued into :func:`pinned_like`'s block, which is not reused while a
    caller holds it. :func:`decode_collect` takes the result."""
    x = ctx.upload(host, staging)
    raw = ctx.run(x)
    replay = (ctx.run, (x,))
    if ctx.device.type != "cuda":
        return Launched(raw, None, replay)
    if to_host:
        host = pinned_like(raw)
        host.copy_(raw, non_blocking=True)
        raw = host
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ctx.device))
    return Launched(raw, ev, replay)


def decode_collect(launched: Launched) -> torch.Tensor:
    """:func:`decode_launch`'s result -> the flat raw frame (in host
    memory with ``to_host``, else on the device), once its work is done."""
    if launched.event is not None:
        launched.event.synchronize()
    return launched.raw
