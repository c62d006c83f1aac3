"""Host-side stage times at 8K, no card needed: the port's counterpart of
the JAX package's ``scripts/perf_host.py``.

    python -m gpujpeg_tpu_torch.tools.perf_host [H W]

The parts of the single-call walls that do not run on the card, for the
bench frame (``tools.bench_frame``) at Q75, restart interval 32,
non-interleaved, with APP13 segment info and without: the encode's
stream assembly (``stream.writer.join_segments`` and ``assemble``),
the decode's parse (``stream.reader.read_image``), plan
(``models.decoder.plan_from_info``) and row build (``ops/decode.build_rows``:
``segment_ranges_wcap``, then the native ``gj_build_rows`` through
``build_segment_rows_from_ranges``, which is where the JAX script's
transposed native build and its NumPy fallback went), and the row
payload the decode uploads. Each stage: min and mean of 5 runs after a
warm-up, host clock. The golden encode that makes the stream is set-up,
timed once.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..models.decoder import plan_from_info
from ..models.encoder import Encoder
from ..ops.decode import (
    build_rows, build_segment_rows_from_ranges, segment_ranges_wcap)
from ..params import ImageParameters, Parameters
from ..plan import make_plan
from ..stream.reader import read_image
from ..stream.writer import assemble, join_segments
from ..tables import encode_tables
from ..types import ColorSpace, PixelFormat
from . import HEIGHT, WIDTH, bench_frame

RUNS = 5


def timed(rows: list, label: str, fn, runs: int = RUNS):
    """``fn()`` once to warm, then ``runs`` times on the host clock; prints
    and appends the stage's row; returns the last result."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"  {label:44s} min {min(times):8.2f} ms   "
          f"mean {np.mean(times):8.2f} ms", flush=True)
    rows.append({"stage": label, "min_ms": min(times),
                 "mean_ms": float(np.mean(times))})
    return out


def run(H: int = HEIGHT, W: int = WIDTH) -> list[dict]:
    """Every stage with and without segment info; one row a stage (and a
    ``row payload`` row a setting, its ``bytes`` the rows' nbytes)."""
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    img = bench_frame(H, W)
    enc = Encoder(backend="golden")
    out = []
    for seginfo in (True, False):
        rows = []
        params = Parameters(quality=75, restart_interval=32,
                            segment_info=seginfo, interleaved=False)
        plan = make_plan(params, image)
        print(f"\n=== {W}x{H} Q75 ri=32 segment_info={seginfo} "
              f"({plan.n_segments} segments) ===", flush=True)
        t0 = time.perf_counter()
        data = enc.encode(img.reshape(-1), params, image)
        print(f"  golden encode (one-time setup)              "
              f"{(time.perf_counter() - t0) * 1e3:10.0f} ms   "
              f"{len(data) / 1e6:.1f} MB stream", flush=True)

        quant_zz, huff = encode_tables(params.quality)
        seg_bytes = enc._encode_segments_golden(img.reshape(-1), plan,
                                                quant_zz, huff)
        bodies = timed(rows, "encode: scan bodies from segment bytes",
                       lambda: join_segments(plan, seg_bytes))
        timed(rows, "encode: assemble (writer + seginfo patch)",
              lambda: assemble(plan, quant_zz, huff, *bodies))

        info = timed(rows, "decode: read_image (marker parse + scan split)",
                     lambda: read_image(data))
        dplan, scan_data, segs = timed(
            rows, "decode: plan + scan tables from info",
            lambda: plan_from_info(info))
        concat, lo, hi, wcap = timed(
            rows, "decode: segment ranges + concat",
            lambda: segment_ranges_wcap(scan_data, segs, dplan))
        timed(rows, "decode: native row build",
              lambda: build_segment_rows_from_ranges(
                  concat, lo, hi, dplan.n_segments, wcap))
        built = timed(rows, "decode: build_rows (ranges + rows)",
                      lambda: build_rows(dplan, scan_data, segs))
        body = sum(s.size for s in scan_data)
        print(f"  row payload: S={dplan.n_segments} wcap={wcap} -> "
              f"{built.nbytes / 1e6:.1f} MB H2D (raw scan body "
              f"{body / 1e6:.1f} MB)", flush=True)
        rows.append({"stage": "row payload", "bytes": int(built.nbytes),
                     "wcap": wcap, "scan_bytes": int(body)})
        for r in rows:
            r["segment_info"] = seginfo
        out += rows
    return out


def main(argv: list | None = None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (0, 2):
        raise SystemExit("usage: python -m gpujpeg_tpu_torch.tools.perf_host "
                         "[H W]")
    return run(*map(int, argv))


if __name__ == "__main__":
    main()
