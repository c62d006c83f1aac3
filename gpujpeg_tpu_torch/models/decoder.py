"""Decoder orchestrator — the analog of ``gpujpeg_decoder_decode``
(reference: src/gpujpeg_decoder.c:206-402).

Pipeline: parse -> Huffman decode -> dequant+IDCT -> postprocess -> raw
output. Backend ``"golden"`` runs it all on the host: the native C++
segment decoder (NumPy golden decoder without a compiler), float64 IDCT
and the NumPy postprocess. Backend ``"torch"`` runs the Huffman decode,
IDCT and postprocess on a torch device (``ops/pipeline.py``) for every
plan (any sampling, interleaved or not, 1/3/4 components) and every
output pixel format and colour space: hand-written CUDA kernels on
``"cuda"``, their plain torch versions on ``"cpu"``; a stream without
restart markers (each scan one segment) takes the lane decoder D1L
(``ops/decode.py``). Like the reference (gpujpeg_decoder.c:238-252),
streams with restart markers in fewer than
:data:`CPU_SEGMENT_THRESHOLD` segments take the host decoder; streams
without them, by the frame's work: fewer than
:data:`CPU_BLOCK_THRESHOLD` blocks.

:meth:`Decoder.decode_batch` pipelines a frame sequence: the next
frame's parse and segment ranges (the row build on the lane route) run
on the host while earlier frames' kernels and copies back proceed. The reference's ``_fuse_frames`` and
``_launch_fused`` (B same-geometry frames vmapped into one launch) have
no counterpart: they amortised the TPU's dispatch floor, and one frame's
kernels already fill the card (``ops/pipeline.py``). Its
``_fuse_compatible`` check is the decode context cache's key
(``pipeline.dec_context``, the last four geometries and table sets).
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import golden
from ..ops.blocks import blocks_to_plane
from ..ops.decode import lane_eligible
from ..ops.preprocess import postprocess
from ..params import ImageParameters, Parameters
from ..plan import make_plan
from ..stream import reader as stream_reader
from ..trace import Tracer
from ..types import ColorSpace, PixelFormat, SamplingFactor

BACKENDS = ("torch", "golden")

#: Below this many segments a stream with restart markers takes the host
#: decoder (reference: gpujpeg_decoder.c:238 uses 32).
CPU_SEGMENT_THRESHOLD = 32
#: A stream without restart markers (the lane route, one segment a scan)
#: of fewer 8x8 blocks than this takes the host decoder, which decodes it
#: faster than the card route's fixed cost a call (the crossover measured
#: on the H100, PERF.md); the reference sends every such stream to the
#: host. 0 sends every such frame to the device.
CPU_BLOCK_THRESHOLD = 128


def huffman_maps(info) -> tuple[list, list]:
    """Per-component DC/AC Huffman tables from the parsed scans.

    Raises :class:`JpegParseError` for scans referencing undefined
    tables or components left without any scan — corrupt streams must
    surface as parse errors, not internal KeyError/None crashes
    (reference rejects unknown table mappings in its SOS parser,
    gpujpeg_reader.c:1136-1252)."""
    from ..stream.reader import JpegParseError
    dc: list = [None] * info.comp_count
    ac: list = [None] * info.comp_count
    for scan in info.scans:
        for sc in scan.components:
            if not (0 <= sc.comp_index < info.comp_count):
                raise JpegParseError(
                    f"scan references component {sc.comp_index} "
                    f"of {info.comp_count}")
            try:
                dc[sc.comp_index] = info.huffman_tables[(0, sc.dc_table)]
                ac[sc.comp_index] = info.huffman_tables[(1, sc.ac_table)]
            except KeyError:
                raise JpegParseError(
                    f"scan references undefined Huffman table "
                    f"(dc={sc.dc_table}, ac={sc.ac_table})") from None
    for c in range(info.comp_count):
        if dc[c] is None or ac[c] is None:
            raise JpegParseError(f"component {c} has no scan")
    return dc, ac


def plan_from_info(info: stream_reader.JpegInfo):
    """A parsed stream -> (its coder plan, per plan scan the scan's bytes,
    per plan scan its (n, 2) int64 segment ranges) (analog of
    gpujpeg_decoder_init, gpujpeg_decoder.c:158-202)."""
    sampling = tuple(c.sampling for c in info.components)
    sampling = sampling + (SamplingFactor(1, 1),) * (4 - len(sampling))
    params = Parameters(
        quality=75,  # unknown from stream; tables come from DQT anyway
        restart_interval=info.restart_interval,
        interleaved=info.interleaved,
        color_space_internal=info.color_space,
        sampling_factor=sampling,
    )
    image = ImageParameters(
        width=info.width, height=info.height,
        color_space=ColorSpace.RGB,
        pixel_format=info.deduce_pixel_format(),
    )
    plan = make_plan(params, image)

    # Map stream scans onto plan scans (non-interleaved plan scans are
    # ordered by component index; foreign streams may order differently).
    scan_data = [np.zeros(0, np.uint8)] * len(plan.scans)
    # per scan: (n, 2) int64 [lo, hi) ranges (ScanInfo.segments)
    segments_by_scan = [np.zeros((0, 2), np.int64) for _ in plan.scans]
    if info.interleaved:
        if info.scans:
            scan_data[0] = info.scans[0].data
            segments_by_scan[0] = info.scans[0].segments
    else:
        for scan in info.scans:
            comp = scan.components[0].comp_index
            scan_data[comp] = scan.data
            segments_by_scan[comp] = scan.segments

    # When the stream has no restart markers, the whole scan is one
    # segment (reference: gpujpeg_common.c:640-650).
    for i, segs in enumerate(segments_by_scan):
        if len(segs) == 0 and scan_data[i].size:
            segments_by_scan[i] = np.array(
                [(0, int(scan_data[i].size))], np.int64)
    return plan, scan_data, segments_by_scan


def golden_planes(info, plan, coeff_scan: np.ndarray) -> list[np.ndarray]:
    """Scan-order coefficients -> the golden decoder's MCU-padded uint8
    planes, one ``(data_height, data_width)`` array per component (float64
    dequant + IDCT)."""
    coeff_plane = np.empty_like(coeff_scan)
    coeff_plane[plan.block_plane_idx] = coeff_scan
    planes = []
    pos = 0
    for c in plan.components:
        qt = info.quant_tables[info.components[c.index].quant_table_index]
        blocks = golden.dequant_idct(coeff_plane[pos:pos + c.block_count], qt)
        planes.append(blocks_to_plane(blocks, c.data_height, c.data_width, np))
        pos += c.block_count
    return planes


class _Job(NamedTuple):
    """A parsed stream's decode operands, in the argument order of
    ``pipeline.decode_device`` after its context cache and device."""
    plan: object
    info: object
    scan_data: list
    segments_by_scan: list
    dc_by_comp: list
    ac_by_comp: list
    out_image: ImageParameters


class DecoderStats:
    def __init__(self) -> None:
        self.duration_stream = 0.0
        self.duration_memory_to = 0.0      # scans and ranges (or rows) up
        self.duration_huffman_coder = 0.0
        self.duration_dct_quantization = 0.0
        self.duration_postprocessor = 0.0
        self.duration_memory_from = 0.0    # raw-image copy to the host
        self.duration_in_gpu = 0.0         # device kernels, to a sync
        self.bytes_memory_to = 0           # upload payload (device path)

    def asdict(self) -> dict[str, float]:
        return dict(self.__dict__)


class Decoder:
    """Reusable decoder. Holds, per recent (geometry, tables), the device
    operands of the torch backend.

    ``device`` is where the torch backend runs. ``"cuda"`` needs a CUDA
    device and raises without one; ``"cpu"`` runs the kernels' plain
    torch versions. The golden backend ignores it.

    ``perf_stats`` fills the device route's per-kernel stage durations
    (reference: ``Decoder(perf_stats=...)``; CUDA events on the card, read
    after the decode's one sync)."""

    def __init__(self, backend: str = "torch", device="cuda",
                 perf_stats: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        self.backend = backend
        self.perf_stats = perf_stats
        self.device = torch.device(device)
        if backend == "torch":
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but no CUDA "
                                   "device is available")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device}")
        self.stats = DecoderStats()
        self.output_format: PixelFormat | None = None
        self.output_color_space: ColorSpace | None = None
        self.output_to_device = False
        #: benchmarking hook: when True, the device route records ``(fn,
        #: args)`` of each decode on :attr:`last_device_call`, ``args``
        #: already on the device, such that ``fn(*args)`` replays the
        #: decode's kernels and returns the same flat raw frame
        self.capture_device_call = False
        self.last_device_call = None
        self._contexts: dict = {}

    def init(self, params, image) -> None:
        """Pre-initialise for a known stream geometry so the first real
        decode skips the kernel build and the per-geometry set-up
        (reference: gpujpeg_decoder_init, gpujpeg_decoder.c:158-202):
        encodes a natural-statistics frame of that geometry with this
        decoder's backend and device, and decodes it to the output
        format set by :meth:`set_output_format`, which warms the decode
        context of either route."""
        from ..types import image_calculate_size
        from .encoder import Encoder
        size = image_calculate_size(image.width, image.height,
                                    image.pixel_format)
        rng = np.random.default_rng(7)
        H = max(image.height, 1)
        rowb = size // H
        y, x = np.mgrid[0:H, 0:rowb]
        buf = np.clip(128 + 80 * np.sin(x / 23.0) * np.cos(y / 17.0)
                      + rng.normal(0, 4.0, (H, rowb)),
                      0, 255).astype(np.uint8).reshape(-1)
        if buf.size < size:     # height-indivisible tail bytes
            buf = np.concatenate([buf, np.full(size - buf.size, 128,
                                               np.uint8)])
        enc = Encoder(backend=self.backend, device=self.device)
        self.decode(enc.encode(buf, params, image))

    def decode_to_device(self, data: bytes):
        """Decode leaving the raw image on the decoder's device: returns
        (flat uint8 tensor in the output's pixel format, ImageParameters)
        when the stream takes the device route — the analog of the
        reference's custom-CUDA-buffer outputs
        (gpujpeg_decoder.c:286-317). Streams that take the host route
        (the golden backend, or a frame under :meth:`_golden_route`'s
        thresholds) return the host NumPy array, as the reference does."""
        self.output_to_device = True
        try:
            return self.decode(data)
        finally:
            self.output_to_device = False

    def decode_batch(self, datas, window: int = 3) -> list:
        """Decode a frame sequence; returns ``[(raw, ImageParameters),
        ...]`` in order, each equal to :meth:`decode` of that stream
        (reference: ``Decoder.decode_batch``). At most ``window`` frames
        are in flight: a frame's parse and segment ranges (its row build
        on the lane route) run on the host before the oldest frame is
        waited for, so they overlap the device work of the frames before
        it. Frames that take the golden route are decoded in turn as
        their own entries; frames of another geometry or table set take
        their own decode context. With :attr:`output_to_device` each
        device-route frame stays on the device. On the card the scans
        and ranges (or rows) go up through pinned memory and each
        frame comes back into pinned memory of its own. A corrupt stream
        raises :class:`JpegParseError` there and leaves the decoder
        usable. Per-frame stats are not recorded; with :attr:`perf_stats`
        the batch is one root span."""
        from ..ops.pipeline import (PinnedRing, decode_collect,
                                    decode_launch, decode_prep)
        if window < 1:
            raise ValueError(f"window must be at least 1, got {window}")
        staging = (PinnedRing(window + 1) if self.backend == "torch"
                   and self.device.type == "cuda" else None)
        out: list = []
        pending: collections.deque = collections.deque()

        def collect():
            raw, out_image = pending.popleft()
            if not isinstance(raw, np.ndarray):
                raw = decode_collect(raw)
                if not self.output_to_device:
                    raw = raw.numpy()
            out.append((raw, out_image))

        tr = Tracer(self.device, "gpujpeg.dec") if self.perf_stats else None
        try:
            for data in datas:
                job = self._job(stream_reader.read_image(data))
                if self._golden_route(job.plan):
                    raw = self._decode_golden(*job)
                else:
                    ctx, host = decode_prep(self._contexts, self.device,
                                            *job)
                    while len(pending) >= window:
                        collect()
                    raw = decode_launch(ctx, host, staging,
                                        not self.output_to_device)
                    if self.capture_device_call:
                        self.last_device_call = raw.replay
                while len(pending) >= window:
                    collect()
                pending.append((raw, job.out_image))
            while pending:
                collect()
        finally:
            if staging is not None:
                staging.wait()
            if tr is not None:
                tr.finish()
        return out

    def set_output_format(self, color_space: ColorSpace,
                          pixel_format: PixelFormat) -> None:
        """(reference: gpujpeg_decoder_set_output_format,
        gpujpeg_decoder.c:410-417)"""
        self.output_color_space = ColorSpace(color_space)
        self.output_format = PixelFormat(pixel_format)

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> tuple[np.ndarray, ImageParameters]:
        """Decode one stream: (the raw frame, its ImageParameters). With
        :attr:`perf_stats` the call's spans are recorded
        (:mod:`gpujpeg_tpu_torch.trace`).

        The frame is a new flat uint8 NumPy array of the caller's own. A
        frame decoded on the card is a view of page-locked host memory
        from torch's caching host allocator: the block is the array's
        while the caller holds it, and returns to the cache when the
        caller drops it, for the next frame of its size
        (``ops/pipeline.py``)."""
        tr = Tracer(self.device, "gpujpeg.dec") if self.perf_stats else None
        try:
            return self._decode(data, tr)
        finally:
            if tr is not None:
                tr.finish()

    def _decode(self, data: bytes, tr: Tracer | None):
        t0 = (tr.open("gpujpeg.dec.stream") if tr is not None
              else time.perf_counter_ns())
        info = stream_reader.read_image(data)
        t1 = tr.close() if tr is not None else time.perf_counter_ns()
        self.stats.duration_stream = (t1 - t0) * 1e-6

        if tr is not None:
            tr.count("gpujpeg.dec.tables_fresh", info.tables_fresh)
            tr.open("gpujpeg.dec.plan")
        job = self._job(info)
        if tr is not None:
            tr.close()
        if self._golden_route(job.plan):
            return self._decode_golden(*job), job.out_image

        from ..ops.pipeline import copy_back, decode_device
        raw, replay, timed = decode_device(self._contexts, self.device, *job,
                                           tr)
        vars(self.stats).update(timed)
        if self.capture_device_call:
            self.last_device_call = replay
        if self.output_to_device:
            return raw, job.out_image
        t0 = (tr.open("gpujpeg.dec.memory_from") if tr is not None
              else time.perf_counter_ns())
        host = copy_back(raw, tr).numpy()
        t1 = tr.close(host.nbytes) if tr is not None else time.perf_counter_ns()
        self.stats.duration_memory_from = (t1 - t0) * 1e-6
        return host, job.out_image

    def _job(self, info) -> "_Job":
        """Parsed stream -> what a decode route takes: its plan, scans,
        segments, Huffman tables and the output's ImageParameters."""
        plan, scan_data, segments_by_scan = plan_from_info(info)
        dc_by_comp, ac_by_comp = huffman_maps(info)
        out_image = ImageParameters(
            width=info.width, height=info.height,
            color_space=(self.output_color_space
                         if self.output_color_space is not None
                         else ColorSpace.RGB),
            # explicit None check: PixelFormat.U8 == 0 is falsy, so an
            # `or` would silently ignore a requested grayscale output
            pixel_format=(self.output_format
                          if self.output_format is not None
                          else info.deduce_pixel_format()),
        )
        return _Job(plan, info, scan_data, segments_by_scan, dc_by_comp,
                    ac_by_comp, out_image)

    def _golden_route(self, plan) -> bool:
        """True when a stream takes the host decoder: the golden backend;
        on the lane route (no restart markers) a frame of fewer than
        :data:`CPU_BLOCK_THRESHOLD` blocks, else fewer than
        :data:`CPU_SEGMENT_THRESHOLD` segments."""
        if self.backend == "golden":
            return True
        if lane_eligible(plan):
            return plan.n_blocks < CPU_BLOCK_THRESHOLD
        return plan.n_segments < CPU_SEGMENT_THRESHOLD

    def _decode_golden(self, plan, info, scan_data, segments_by_scan,
                       dc_by_comp, ac_by_comp, out_image) -> np.ndarray:
        t1 = time.perf_counter()
        from ..native import decode_segments_native
        coeff_scan = decode_segments_native(
            plan, scan_data, segments_by_scan, dc_by_comp, ac_by_comp)
        if coeff_scan is None:  # no compiler available
            coeff_scan = golden.decode_segments(
                plan, scan_data, segments_by_scan, dc_by_comp, ac_by_comp)
        t2 = time.perf_counter()
        planes = golden_planes(info, plan, coeff_scan)
        t3 = time.perf_counter()
        raw = postprocess(planes, out_image, plan, np)
        t4 = time.perf_counter()
        self.stats.duration_huffman_coder = (t2 - t1) * 1e3
        self.stats.duration_dct_quantization = (t3 - t2) * 1e3
        self.stats.duration_postprocessor = (t4 - t3) * 1e3
        return np.asarray(raw)
