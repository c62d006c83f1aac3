"""Measurement tools of the port: the counterparts of the JAX package's
bench entry points and stage-1 probe scripts, each runnable as a module.

* :mod:`.bench` (``bench.py``): the headline line, the 8K Q75 encode's
  device time beside the GTX 3080's, with the decode, the end-to-end
  times and the first call, behind the route gate;
* :mod:`.bench_suite` (``bench_suite.py``): HD to 16K, the video batch
  and the Q10-Q100 sweep;
* :mod:`.perf_host` (``scripts/perf_host.py``): the host stages of the
  single-call walls, no card needed.

The first two take ``--device cpu`` (and a small ``--height``/
``--width``) for the tests, where every time is null; ``perf_host``
takes ``H W``. The probes:

* :mod:`.perf_stage1` (``scripts/perf_stage1.py``): the card's copy rate
  (``copy_bytes`` against ``Tensor.clone()``), E12 on the script's
  inputs, and E2 + E3 on its random coefficients;
* :mod:`.ablate_stage1` (``scripts/ablate_stage1.py``): E12 cut after
  each stage;
* :mod:`.perf_rgbpack` (``scripts/perf_rgbpack.py``): E0 on RGB 4:4:4
  against the copy floor of the same bytes.

Each defaults to ``--device cuda`` at 8K (7680x4320) and takes
``--device cpu --height H --width W`` for a small run on the plain
versions; each draws its inputs with ``np.random.default_rng(0)`` in the
order its JAX script does. The TPU tile sweeps of the scripts have no
counterpart; the tools print each kernel's launch configuration instead.
A kernel's exception is not caught.

:mod:`.reformat` is a host tool, the copy of the JAX package's JPEG
reformatter (APP13 segment info added to a foreign stream).

:mod:`.soak` (``scripts/soak.py``) runs random geometries and corrupt
streams through the card's coders, each case held to the CPU route and
the golden coder by the rules of :mod:`.checks`, which ``chip_smoke.py``
shares.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

#: the JAX scripts' frame
HEIGHT, WIDTH = 4320, 7680
#: ``mean_ms(..., hold=True)``: cycles the card spins
#: (``torch.cuda._sleep``) before the timed runs, per run (about 0.2 ms
#: at the H100's 1.98 GHz)
HOLD_CYCLES_PER_RUN = 400_000


#: rows of :func:`bench_frame` built at a time (its float64 temporaries
#: take about 100 B a pixel of a band: 0.8 GB a band at 16K)
BAND_ROWS = 512


def bench_frame(H: int, W: int, seed: int = 7,
                band_rows: int = BAND_ROWS) -> np.ndarray:
    """The JAX package's bench frame (bench.make_image): smooth colour
    gradients plus Gaussian noise, (H, W, 3) uint8 from a numpy seed.
    Built ``band_rows`` rows at a time with the same recipe and one
    generator drawn in row order, so the bytes are those of the whole
    frame built at once, and a 16K frame needs no 3 GB of temporaries."""
    rng = np.random.default_rng(seed)
    out = np.empty((H, W, 3), np.uint8)
    for y0 in range(0, H, band_rows):
        y, x = np.mgrid[y0:min(H, y0 + band_rows), 0:W]
        img = np.stack([
            128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0),
            128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0),
            128 + 70 * np.sin((x + y) / 41.0),
        ], axis=-1)
        img += rng.normal(0, 3.0, img.shape)
        out[y0:y0 + len(img)] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of ``dev``'s card (``cpu`` on
    the CPU); raise if ``nvidia-smi`` fails."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index
    if index is None:   # the current device, without making a context
        index = (torch.cuda.current_device() if torch.cuda.is_initialized()
                 else 0)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
    if index < len(visible) and visible[index].strip():
        index = visible[index].strip()
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", str(index)],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def parse_args(description: str, stages: tuple,
               argv: list | None) -> argparse.Namespace:
    """The tools' shared command line: stages (all when none is named),
    device, frame size, repeats."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("stages", nargs="*",
                   help=f"stages to run (default: all of {', '.join(stages)})")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--reps", type=int, default=20,
                   help="timed runs after one warm-up")
    args = p.parse_args(argv)
    bad = [s for s in args.stages if s not in stages]
    if bad:
        p.error(f"unknown stages {bad}; choose from {list(stages)}")
    args.stages = [s for s in stages if s in args.stages] or list(stages)
    return args


def device(name: str) -> torch.device:
    """The tools' device; ``cuda`` without a card raises (no fallback)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; use --device "
                           "cpu for the plain versions")
    return torch.device(name)


def mean_ms(fn, dev: torch.device, reps: int,
            hold: bool = False) -> tuple[float, str]:
    """(mean ms of ``fn()`` over ``reps`` runs after one warm-up, the
    clock): CUDA events on a card, the host clock on the CPU.

    Without ``hold`` the events also take in the host time of the first
    run's launch (a wrapper's checks and allocation), spread over the
    runs. With ``hold`` the card first spins ``HOLD_CYCLES_PER_RUN`` cycles
    a run, so that every run is queued before the first starts and the
    events time the card alone; that holds only where the host queues one
    run in fewer cycles and ``fn`` does not sync."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps, "host clock"
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES_PER_RUN * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps, "CUDA events"


def report(tool: str, rows: list[dict]) -> None:
    """One line per row: its stage, kernel, time and the rest."""
    for r in rows:
        rest = ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                         else f"{k} {v}" for k, v in r.items()
                         if k not in ("stage", "kernel", "ms", "clock"))
        print(f"{tool} {r['stage']}: {r['kernel']} {r['ms']:.4f} ms "
              f"({r['clock']}); {rest}", flush=True)
