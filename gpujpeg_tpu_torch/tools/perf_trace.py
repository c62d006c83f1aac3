"""The tracer's cost (``gpujpeg_tpu_torch.trace``): ``Encoder.encode`` and
``Decoder.decode_to_device`` on frames already on the card, in three
states taken in turns: perf stats off, perf stats on with no profiler
recording, and perf stats on under ``torch.profiler`` (CPU and CUDA
activities). Then the cost of one span site alone: with perf stats off
(a ``None`` check) and of one span opened and closed, with and without
the profiler.

    python -m gpujpeg_tpu_torch.tools.perf_trace [hd] [8k]
        [--turns 5] [--calls 200]

``hd`` is 1920x1080 I420 (BT.709) to 4:2:0 interleaved Q75, restart
interval 4; ``8k`` is 7680x4320 RGB to YCbCr 4:4:4 non-interleaved Q75,
restart interval 32. Each call's latency is the host clock around it
(the encode returns the stream's bytes, the decode syncs). Prints one
line a cell and state: the calls, the median and p95 latency in ms, and
the spans a call; then the span sites' cost in us, and on the card that
of a device mark and of a stage duration's read. ``--device cpu``
(with ``--scale``) runs the plain versions, for the tests.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from .. import trace
from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..params import ImageParameters, Parameters
from ..types import ColorSpace, PixelFormat, SamplingFactor
from . import bench_frame, card_line, device

STATES = ("off", "on", "profiler")
#: the cells' geometry and coding: (height, width, input and output
#: pixel format, colour space, sampling, interleaved, restart interval)
CELLS = {
    "hd": (1080, 1920, PixelFormat.PF_420_U8_P0P1P2, ColorSpace.YCBCR_BT709,
           ((2, 2), (1, 1), (1, 1)), True, 4),
    "8k": (4320, 7680, PixelFormat.PF_444_U8_P012, ColorSpace.RGB,
           ((1, 1), (1, 1), (1, 1)), False, 32),
}


def i420(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> the flat I420 bytes of its BT.709 luma and
    2x2-averaged chroma (H and W even)."""
    f = rgb.astype(np.float32)
    y = 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]
    cb = (f[..., 2] - y) / 1.8556 + 128
    cr = (f[..., 0] - y) / 1.5748 + 128
    H, W = y.shape
    sub = [c.reshape(H // 2, 2, W // 2, 2).mean((1, 3)) for c in (cb, cr)]
    planes = [y.reshape(-1)] + [c.reshape(-1) for c in sub]
    return np.clip(np.rint(np.concatenate(planes)), 0, 255).astype(np.uint8)


def coders(cell: str, dev: torch.device, scale: int):
    """(encoder, params without and with perf stats, image, decoder, the
    frame on ``dev``) of ``cell``, its size divided by ``scale``."""
    H, W, pf, cs, samp, inter, ri = CELLS[cell]
    H, W = H // scale // 16 * 16, W // scale // 16 * 16
    rgb = bench_frame(H, W)
    raw = i420(rgb) if pf == PixelFormat.PF_420_U8_P0P1P2 else rgb.reshape(-1)
    image = ImageParameters(width=W, height=H, color_space=cs,
                            pixel_format=pf)
    factors = tuple(SamplingFactor(h, v) for h, v in samp)
    params = {on: Parameters(quality=75, restart_interval=ri,
                             interleaved=inter, perf_stats=on,
                             sampling_factor=factors + (SamplingFactor(1, 1),),
                             color_space_internal=ColorSpace.YCBCR_BT601_256LVLS)
              for on in (False, True)}
    dec = Decoder(backend="torch", device=dev)
    dec.set_output_format(cs, pf)
    return (Encoder(backend="torch", device=dev), params, image, dec,
            torch.from_numpy(raw).to(dev))


def _timed(fn, n: int, sync) -> list:
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _p95(v: list) -> float:
    return float(np.percentile(v, 95))


def measure_cell(cell: str, dev: torch.device, turns: int, calls: int,
                 scale: int) -> list[dict]:
    """One row a phase and state: calls, median and p95 ms, spans a call."""
    from torch.profiler import ProfilerActivity, profile
    enc, params, image, dec, frame = coders(cell, dev, scale)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    stream = enc.encode(frame, params[False], image)
    for on in (False, True):        # warm both paths, and the profiler
        dec.perf_stats = on
        for _ in range(3):
            enc.encode(frame, params[on], image)
            dec.decode_to_device(stream)
    with profile(activities=acts):
        enc.encode(frame, params[True], image)
    lat = {(p, s): [] for p in ("encode", "decode") for s in STATES}
    spans = {"encode": 0, "decode": 0}
    for k in range(turns):     # each turn starts at the next state
        for state in STATES[k % 3:] + STATES[:k % 3]:
            on = state != "off"
            dec.perf_stats = on
            prof = profile(activities=acts) if state == "profiler" else None
            if prof is not None:
                prof.start()
            trace.clear()
            lat["encode", state] += _timed(
                lambda: enc.encode(frame, params[on], image), calls, sync)
            n_enc = len(trace.spans())
            lat["decode", state] += _timed(
                lambda: dec.decode_to_device(stream), calls, sync)
            if state == "on":
                spans["encode"] = n_enc / calls
                spans["decode"] = (len(trace.spans()) - n_enc) / calls
            if prof is not None:
                prof.stop()
    if trace.dropped():
        raise RuntimeError(f"{trace.dropped()} spans dropped")
    trace.clear()
    return [{"cell": cell, "phase": p, "state": s, "calls": len(v),
             "median_ms": statistics.median(v), "p95_ms": _p95(v),
             "spans_a_call": spans[p] if s != "off" else 0.0}
            for (p, s), v in lat.items()]


def site_us(dev: torch.device, reps: int = 200_000) -> dict:
    """us of one span site: with perf stats off (the ``None`` check, less
    an empty loop), and one span opened and closed, without and with the
    profiler recording (CPU activity); on a card also one device mark (a
    CUDA event made and recorded) and one stage duration read from two."""
    from torch.profiler import ProfilerActivity, profile
    tr = None
    t = time.perf_counter()
    for _ in range(reps):
        pass
    empty = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(reps):
        if tr is not None:
            tr.open("gpujpeg.enc.launch")
    off = (time.perf_counter() - t - empty) / reps * 1e6
    trace.clear()
    tr = trace.Tracer(torch.device("cpu"), "gpujpeg.enc")
    n = min(reps, trace.CAPACITY // 2) // 10
    t = time.perf_counter()
    for _ in range(n):
        tr.open("gpujpeg.enc.launch")
        tr.close()
    on = (time.perf_counter() - t) / n * 1e6
    with profile(activities=[ProfilerActivity.CPU]):
        t = time.perf_counter()
        for _ in range(n):
            tr.open("gpujpeg.enc.launch")
            tr.close()
        prof = (time.perf_counter() - t) / n * 1e6
    tr.finish()
    out = {"off_us": off, "on_us": on, "profiler_us": prof}
    if dev.type == "cuda":
        tr = trace.Tracer(dev, "gpujpeg.enc")
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(n):
            tr.mark()
        out["mark_us"] = (time.perf_counter() - t) / n * 1e6
        t = time.perf_counter()
        tr.durations()
        out["duration_us"] = (time.perf_counter() - t) / (n - 1) * 1e6
        tr.finish()
    trace.clear()
    return out


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells", nargs="*",
                   help=f"cells to run (default: all of {', '.join(CELLS)})")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--turns", type=int, default=5)
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--scale", type=int, default=1,
                   help="divide each frame's height and width by this")
    a = p.parse_args(argv)
    bad = [c for c in a.cells if c not in CELLS]
    if bad:
        p.error(f"unknown cells {bad}; choose from {list(CELLS)}")
    dev = device(a.device)
    print(f"perf_trace: card {card_line(dev)}; torch {torch.__version__}",
          flush=True)
    for cell in a.cells or list(CELLS):
        for r in measure_cell(cell, dev, a.turns, a.calls, a.scale):
            print("perf_trace {cell} {phase} {state}: {calls} calls, median "
                  "{median_ms:.4f} ms, p95 {p95_ms:.4f} ms, {spans_a_call:.1f} "
                  "spans a call".format(**r), flush=True)
    s = site_us(dev)
    print(f"perf_trace sites: off {s['off_us']:.4f} us a site, on "
          f"{s['on_us']:.3f} us a span, under the profiler "
          f"{s['profiler_us']:.3f} us a span" + (
              f"; a device mark {s['mark_us']:.3f} us, a stage duration "
              f"read {s['duration_us']:.3f} us" if "mark_us" in s else ""),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
