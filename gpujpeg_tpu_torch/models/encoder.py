"""Encoder orchestrator — the analog of ``gpujpeg_encoder_encode``
(reference: src/gpujpeg_encoder.c:287-548).

Pipeline: plan -> preprocess -> DCT+quant -> segment-parallel Huffman ->
stream assembly. The compute stages run either on the host golden path
(NumPy and the native C++ coder; backend ``"golden"``) or on a torch
device (backend ``"torch"``): hand-written CUDA kernels on ``"cuda"``,
their plain torch versions on ``"cpu"``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import golden
from ..ops.blocks import plane_to_blocks
from ..ops.huffman_encode import COMPACT_CHUNK_BYTES
from ..ops.preprocess import preprocess, upload_raw
from ..params import ImageParameters, Parameters
from ..plan import CoderPlan, make_plan
from ..stream.writer import HeaderType, assemble, join_segments
from ..tables import encode_tables
from ..trace import Tracer
from ..types import HuffmanType, image_calculate_size

BACKENDS = ("torch", "golden")


class EncoderStats:
    """Per-stage durations in ms (analog of struct gpujpeg_duration_stats,
    gpujpeg_common.h:315-325). With ``Parameters.perf_stats`` the torch
    route fills the upload, each kernel stage and the copy back
    (``ops/pipeline.py``: CUDA events on the card, the host clock on the
    CPU); the golden route fills its three host stages."""

    def __init__(self) -> None:
        self.duration_memory_to = 0.0      # raw upload (perf_stats)
        self.duration_preprocessor = 0.0   # E0 (0 on the E1 route)
        self.duration_dct_quantization = 0.0
        self.duration_huffman_coder = 0.0  # E2 + E3
        self.duration_memory_from = 0.0    # compaction + copy back (perf_stats)
        self.duration_stream = 0.0
        self.duration_in_gpu = 0.0   # upload + kernels + length sync

    def asdict(self) -> dict[str, float]:
        return dict(self.__dict__)


class Encoder:
    """Reusable encoder. Holds table state and, per (params, image), the
    device operands of the torch backend (the reference re-uses its coder
    the same way, gpujpeg_encoder.c:300-315).

    ``device`` is where the torch backend runs. ``"cuda"`` needs a CUDA
    device and raises without one; ``"cpu"`` runs the kernels' plain
    torch versions. The golden backend ignores it."""

    def __init__(self, backend: str = "torch", device="cuda",
                 header_type: HeaderType = HeaderType.DEFAULT):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        self.backend = backend
        self.device = torch.device(device)
        if backend == "torch":
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but no CUDA "
                                   "device is available")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device}")
        self.header_type = header_type
        self.stats = EncoderStats()
        self._contexts: dict = {}

    # ------------------------------------------------------------------
    def warmup(self, params: Parameters, image: ImageParameters) -> None:
        """Prepare for a geometry before the first real encode (the
        analog of the reference's gpujpeg_encoder_allocate and
        first-iteration cost, gpujpeg_encoder.c:221-254, FAQ.md:14-19): on
        a CUDA device builds or loads the kernel library, then encodes a
        zero frame of the geometry, which sets up its device operands."""
        if self.backend == "torch" and self.device.type == "cuda":
            from .. import _build
            _build.load_kernels()
        size = image_calculate_size(image.width, image.height,
                                    image.pixel_format)
        self.encode(np.zeros(size, np.uint8), params, image)

    def allocate(self, params: Parameters, image: ImageParameters) -> None:
        """Pre-allocate for a geometry before the first encode
        (reference: gpujpeg_encoder_allocate, gpujpeg_encoder.c:221-254).
        Alias of :meth:`warmup`."""
        self.warmup(params, image)

    #: Device bytes of one torch encode at its peak, a pixel, at the worst
    #: sampling (4:4:4 with 4 components, RGBA in: 4 blocks a 64 pixels)
    #: and any quality (E2 and E3 are sized for the worst block, so the
    #: quality does not change them). The peak comes while E3 runs: the
    #: card holds the raw frame (at most 4 B a pixel) and, a block, its
    #: coefficients (256 B), E2's string row (224 B) and bit length (4 B),
    #: E3's output row (448 B, every byte of the worst string stuffed; 464
    #: at restart interval 1 with the marker and the row rounded to 16),
    #: the context's block geometry (16 B) and, at one block a segment,
    #: the segment arrays and E3's lengths (28 B): 4 + 4 * 992 / 64 = 66.
    #: E0's planes (at most 4 B a pixel) are freed before E2 allocates,
    #: and the compaction that follows E3 holds the raw frame and E3's
    #: rows, counted here, and scratch of its own, which is not a pixel's
    #: (:attr:`_DEVICE_BYTES_FIXED`). ``encode_batch`` holds three
    #: frames' raw frames and E3 rows at once.
    _DEVICE_BYTES_PER_PIXEL = 66
    #: the compaction's scratch: 24 B of int64 indices and 1 B of output
    #: for each byte of a chunk (``huffman_encode.compact_segments``)
    _DEVICE_BYTES_FIXED = 25 * COMPACT_CHUNK_BYTES

    @classmethod
    def max_pixels(cls, memory_bytes: int) -> int:
        """Largest image (in pixels) whose torch encode fits in
        ``memory_bytes`` of device memory, by the bound of
        :meth:`max_memory` (reference: gpujpeg_encoder_max_pixels,
        gpujpeg_encoder.c:132-168)."""
        return max(0, (memory_bytes - cls._DEVICE_BYTES_FIXED)
                   // cls._DEVICE_BYTES_PER_PIXEL)

    @classmethod
    def max_memory(cls, pixels: int) -> int:
        """Device memory (bytes) that bounds the peak of one torch encode
        of ``pixels`` at any quality, sampling and pixel format (reference:
        gpujpeg_encoder_max_memory, gpujpeg_encoder.c:171-218); blocks of
        MCU padding count as pixels."""
        return pixels * cls._DEVICE_BYTES_PER_PIXEL + cls._DEVICE_BYTES_FIXED

    def encode(self, raw, params: Parameters, image: ImageParameters) -> bytes:
        """Encode one frame to a JPEG byte stream.

        ``raw`` is bytes, a NumPy array or a tensor in the image's pixel
        format: a ``torch.uint8`` tensor, or an ``int32`` one read as its
        little-endian bytes (the JAX package's words form). A tensor on
        the encoder's device is not copied (the analog of the reference's
        device-pointer inputs, gpujpeg_encoder.c:353-395), such as
        ``Decoder.decode_to_device``'s frame; one on another device is
        copied there once. The host route (``restart_interval == 0``)
        brings a tensor to the host once. With ``params.perf_stats`` the
        call's spans are recorded (:mod:`gpujpeg_tpu_torch.trace`)."""
        tr = Tracer(self.device, "gpujpeg.enc") if params.perf_stats else None
        try:
            return self._encode(raw, params, image, tr)
        finally:
            if tr is not None:
                tr.finish()

    def _encode(self, raw, params: Parameters, image: ImageParameters,
                tr: Tracer | None) -> bytes:
        if tr is not None:
            tr.open("gpujpeg.enc.plan")
        plan = make_plan(params, image)
        quant_zz, huff = encode_tables(params.quality)
        if tr is not None:
            tr.close()

        # restart_interval == 0 means one segment per whole scan: there is
        # no segment parallelism, so the host Huffman coder encodes it,
        # exactly like the reference (gpujpeg_encoder.c:437-446)
        if self.backend == "torch" and params.restart_interval > 0:
            from ..ops.pipeline import encode_segments_device
            scan_bodies, seg_sizes_by_scan, timed = encode_segments_device(
                self._contexts, self.device, raw, plan, quant_zz, huff, tr)
            vars(self.stats).update(timed)
        else:
            if isinstance(raw, torch.Tensor):   # checked, to the host once
                raw = upload_raw(raw, image, "cpu").numpy()
            scan_bodies, seg_sizes_by_scan = join_segments(
                plan, self._encode_segments_golden(raw, plan, quant_zz, huff))

        t0 = (tr.open("gpujpeg.enc.stream") if tr is not None
              else time.perf_counter_ns())
        out = assemble(plan, quant_zz, huff, scan_bodies, seg_sizes_by_scan,
                       self.header_type)
        t1 = tr.close() if tr is not None else time.perf_counter_ns()
        self.stats.duration_stream = (t1 - t0) * 1e-6
        return out

    def encode_batch(self, raws, params: Parameters,
                     image: ImageParameters) -> list[bytes]:
        """Encode same-geometry frames; returns one JPEG byte stream a
        frame, each equal to :meth:`encode` of that frame (reference:
        ``Encoder.encode_batch``). On the torch backend with restart
        markers, up to three frames' device work is queued ahead of
        each frame's copy back and stream assembly
        (``pipeline.encode_batch_device``); ``restart_interval == 0`` and
        the golden backend encode frame by frame. Frames may be host
        bytes, NumPy arrays or tensors, as :meth:`encode` takes them.
        Per-frame stats are not recorded; with ``params.perf_stats`` the
        pipelined batch is one root span."""
        if self.backend != "torch" or params.restart_interval <= 0:
            return [self.encode(r, params, image) for r in raws]
        from ..ops.pipeline import encode_batch_device
        tr = Tracer(self.device, "gpujpeg.enc") if params.perf_stats else None
        try:
            plan = make_plan(params, image)
            quant_zz, huff = encode_tables(params.quality)
            return [assemble(plan, quant_zz, huff, *result, self.header_type)
                    for result in encode_batch_device(
                        self._contexts, self.device, raws, plan, quant_zz,
                        huff)]
        finally:
            if tr is not None:
                tr.finish()

    # ------------------------------------------------------------------
    def _encode_segments_golden(self, raw, plan: CoderPlan, quant_zz, huff):
        t0 = time.perf_counter()
        planes = preprocess(raw, plan.image, plan, np)
        t1 = time.perf_counter()
        coeff_plane = np.concatenate([
            golden.fdct_quant(plane_to_blocks(planes[c.index], np),
                              quant_zz[c.quant_table_index])
            for c in plan.components
        ])
        coeff_scan = coeff_plane[plan.block_plane_idx]
        t2 = time.perf_counter()
        dc_by_comp = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
        ac_by_comp = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
        from ..native import encode_segments_native
        seg_bytes = encode_segments_native(plan, coeff_scan, dc_by_comp, ac_by_comp)
        if seg_bytes is None:  # no compiler available
            seg_bytes = golden.encode_segments(plan, coeff_scan, dc_by_comp, ac_by_comp)
        t3 = time.perf_counter()
        self.stats.duration_preprocessor = (t1 - t0) * 1e3
        self.stats.duration_dct_quantization = (t2 - t1) * 1e3
        self.stats.duration_huffman_coder = (t3 - t2) * 1e3
        return seg_bytes
