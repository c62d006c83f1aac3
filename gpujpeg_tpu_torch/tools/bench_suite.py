"""The full benchmark suite on the card; the port's counterpart of the
JAX package's ``bench_suite.py`` (``tools.bench`` stays the one-line
headline).

    python -m gpujpeg_tpu_torch.tools.bench_suite [--sweep] [--sweep-only]
        [--no-16k] [--device cuda|cpu] [--height H --width W]

* HD, 4K, 8K and 16K encode and decode, RGB 4:4:4, Q75,
  non-interleaved, restart interval ``suggest_restart_interval(
  pow2=True)`` (:func:`bench_res`): the encoder's device pipeline on a
  frame already on the card (E1 -> E2 -> E3) and the replayed device
  decode (``capture_device_call``: D1 -> D2), both by CUDA events, at
  the depths ``{HD: 5i, 4K: 2i, 8K: i, 16K: 3}`` with ``BENCH_ITERS``
  = i (default 20); each row also holds the peak device memory of the
  first encode beside ``Encoder.max_memory``;
* the video batch at HD (:func:`bench_video`): 100 device-pipeline runs
  over 4 frames (seeds 0-3) by CUDA events, then ``Encoder.encode_batch``
  of ``max(10, iters // 4)`` frames from host memory and
  ``Decoder.decode_batch`` of as many streams with ``output_to_device``,
  host clock, in frames a second;
* with ``--sweep`` (or ``--sweep-only``) Q10..Q100 at 8K
  (:func:`sweep_row`), the interval with the quality clamp of
  ``suggest_restart_interval`` (16 at Q80 and Q90), encode and decode
  over 8 runs each.

The port has one device route for this geometry, so every row's encode
must take E1 -> E2 -> E3 and its decode D1 -> D2 (checked by the
route's launch counts on the card; ``variant`` is ``"E1-E3"``), or the
run fails. ``bench_suite.py``'s downgrade to a host coder and its
``decode_err`` rows have no counterpart: a kernel that fails ends the run
with its exception. One JSON line a row goes to standard error, each with
``card`` (``nvidia-smi``'s name and power limit), and the table of the
resolution and video rows to standard output. ``--device cpu`` runs the
plain versions, for the tests: ``card`` is ``cpu`` and every time and
rate is null. ``--height``/``--width`` replace every row's size.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..ops.pipeline import enc_context
from ..plan import make_plan
from ..tables import encode_tables
from . import bench, bench_frame, card_line, device
from .bench import ENCODE_ROUTE, config, counted, host_ms, log, route_failures

# GTX 3080 w/o PCIe transfers (BASELINE.md); 16K encode extrapolated from
# the with-PCIe ratio
BASE_ENC = {"HD": 0.21, "4K": 0.75, "8K": 2.30, "16K": 9.2}
BASE_DEC = {"HD": 0.25, "4K": 0.85, "8K": 2.38, "16K": 11.1}
RES = {"HD": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680),
       "16K": (8640, 15360)}
#: the sweep's qualities and runs a quality
SWEEP_QUALITIES = tuple(range(10, 101, 10))
SWEEP_RUNS = 8


def _rate(mpix: float, ms: float | None) -> float | None:
    return None if ms is None else mpix / ms * 1e3


def _cell(v) -> str:
    return "" if v is None else f"{v:.4f}" if isinstance(v, float) else str(v)


def _check(failures: list[str]) -> None:
    if failures:
        raise RuntimeError("BENCH FAIL: " + "; ".join(failures))


def device_decode(stream: bytes, dev: torch.device,
                  runs: int) -> float | None:
    """``bench.device_decode``'s time of the stream's device decode (D1 ->
    D2); fails unless the route gate held."""
    dec = Decoder(backend="torch", device=dev)
    dec.output_to_device = True
    dec.capture_device_call = True
    dec.decode(stream)
    ms, _, failures = bench.device_decode(dec, dev, runs)
    _check(failures)
    return ms


def peak_encode(enc: Encoder, img: np.ndarray, params, image,
                dev: torch.device) -> tuple[bytes, int | None]:
    """(``enc.encode`` of ``img``, the device bytes allocated at its peak
    above those allocated before it; None on the CPU)."""
    if dev.type != "cuda":
        return enc.encode(img, params, image), None
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = enc.encode(img, params, image)
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base


def bench_res(name: str, iters: int, device_name: str = "cuda",
              size: tuple[int, int] | None = None,
              img: np.ndarray | None = None) -> tuple[dict, bytes]:
    """Config ``name`` of :data:`RES` (or ``size`` = (H, W)) at Q75 on
    ``img`` (the bench frame when not given): (its row, its stream). The
    first encode's peak memory is measured beside ``Encoder.max_memory``;
    the device encode and decode are timed over ``iters`` runs each."""
    dev = device(device_name)
    H, W = RES[name] if size is None else size
    if img is None:
        img = bench_frame(H, W)
    image, params = config(H, W)
    enc = Encoder(backend="torch", device=dev)
    out, peak = peak_encode(enc, img, params, image, dev)
    enc_ms, _, failures = bench.device_encode(enc, img, params, image, dev,
                                              iters)
    _check(failures)
    dec_ms = device_decode(out, dev, iters)
    mpix = W * H / 1e6
    row = dict(config=name, mpix=round(mpix, 1),
               encode_device_ms=enc_ms, decode_device_ms=dec_ms,
               encode_mpix_s=_rate(mpix, enc_ms),
               decode_mpix_s=_rate(mpix, dec_ms),
               jpeg_mb=round(len(out) / 1e6, 2),
               vs_3080_encode=None if enc_ms is None
               else BASE_ENC[name] / enc_ms,
               vs_3080_decode=None if dec_ms is None
               else BASE_DEC[name] / dec_ms,
               restart_interval=params.restart_interval,
               encode_peak_bytes=peak,
               max_memory=Encoder.max_memory(W * H),
               card=card_line(dev))
    log(json.dumps(row))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, out


def bench_video(iters: int = 100, device_name: str = "cuda",
                size: tuple[int, int] | None = None) -> dict:
    """Same-geometry frames at HD (or ``size``) 4:4:4 Q75, the reference's
    ``-n`` iteration mode: ``iters`` device-pipeline runs over 4 frames
    (CUDA events), then ``encode_batch`` and ``decode_batch`` (with
    ``output_to_device``) of ``max(10, iters // 4)`` frames each, host
    clock; frames a second and Mpix a second."""
    dev = device(device_name)
    cuda = dev.type == "cuda"
    H, W = RES["HD"] if size is None else size
    image, params = config(H, W)
    enc = Encoder(backend="torch", device=dev)
    frames = [bench_frame(H, W, seed=s) for s in range(4)]
    enc.encode(frames[0], params, image)
    plan = make_plan(params, image)
    ctx = enc_context(enc._contexts, plan, *encode_tables(params.quality),
                      dev)
    devs = [ctx.upload(f) for f in frames]

    def runs():
        ctx.run(devs[0])
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        for i in range(iters):
            ctx.run(devs[i % 4])
        if cuda:
            stop.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(stop)
    ms, launches = counted(ENCODE_ROUTE, runs)
    _check(route_failures("the video encode", ENCODE_ROUTE, launches,
                          iters + 1, ctx.rgb_route, dev))
    del devs

    n = max(10, iters // 4)
    batch = [frames[i % 4] for i in range(n)]
    enc_ms = host_ms(lambda: enc.encode_batch(batch, params, image), dev)
    streams = [enc.encode(f, params, image) for f in frames]
    dec = Decoder(backend="torch", device=dev)
    dec.output_to_device = True
    dec.decode(streams[0])
    sbatch = [streams[i % 4] for i in range(n)]
    dec_ms = host_ms(lambda: dec.decode_batch(sbatch), dev)
    if not cuda:
        enc_ms = dec_ms = None
    mpix = W * H / 1e6

    def fps(k, total_ms):
        return None if total_ms is None else k / total_ms * 1e3
    row = dict(config=f"video_{iters}x" + ("HD" if size is None
                                           else f"{W}x{H}"),
               fps=fps(iters, ms), mpix_s=_rate(iters * mpix, ms),
               encode_e2e_fps=fps(n, enc_ms),
               encode_e2e_mpix_s=_rate(n * mpix, enc_ms),
               decode_fps=fps(n, dec_ms),
               decode_mpix_s=_rate(n * mpix, dec_ms),
               card=card_line(dev))
    log(json.dumps(row))
    return row


def sweep_row(q: int, img: np.ndarray, dev: torch.device,
              name: str = "8K") -> tuple[dict, bytes]:
    """Quality ``q`` on ``img`` with the quality clamp of the restart
    interval: (its row, its stream), encode and decode over
    :data:`SWEEP_RUNS` runs each."""
    H, W, _ = img.shape
    image, params = config(H, W, q, quality_clamp=True)
    enc = Encoder(backend="torch", device=dev)
    out = enc.encode(img, params, image)
    enc_ms, _, failures = bench.device_encode(enc, img, params, image, dev,
                                              SWEEP_RUNS)
    _check(failures)
    dec_ms = device_decode(out, dev, SWEEP_RUNS)
    row = dict(config=f"{name}_Q{q}", jpeg_mb=round(len(out) / 1e6, 2),
               variant="E1-E3", restart_interval=params.restart_interval,
               encode_device_ms=enc_ms, decode_device_ms=dec_ms,
               card=card_line(dev))
    log(json.dumps(row))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, out


def main(argv: list | None = None) -> list[dict]:
    """Run the suite; returns its rows (resolutions, video, sweep)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--sweep-only", action="store_true")
    p.add_argument("--no-16k", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    args = p.parse_args(argv)
    dev = device(args.device)
    size = None
    if args.height or args.width:
        if not (args.height and args.width):
            p.error("--height and --width go together")
        size = (args.height, args.width)
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    log(f"card: {card_line(dev)}; torch {torch.__version__}")

    rows = []
    if not args.sweep_only:
        depth = {"HD": 5 * iters, "4K": 2 * iters, "8K": iters, "16K": 3}
        for name in ("HD", "4K", "8K") + (() if args.no_16k else ("16K",)):
            rows.append(bench_res(name, depth[name], args.device, size)[0])
        rows.append(bench_video(device_name=args.device, size=size))
    sweep = []
    if args.sweep or args.sweep_only:
        H, W = RES["8K"] if size is None else size
        img = bench_frame(H, W)
        name = "8K" if size is None else f"{W}x{H}"
        sweep = [sweep_row(q, img, dev, name)[0] for q in SWEEP_QUALITIES]

    hdr = ("config", "mpix", "encode_device_ms", "decode_device_ms",
           "encode_mpix_s", "decode_mpix_s")
    print("\t".join(hdr))
    for r in rows:
        print("\t".join(_cell(r.get(k)) for k in hdr))
    return rows + sweep


if __name__ == "__main__":
    main()
