"""Runs one cell of the benchmark of ``gpujpeg_tpu_torch`` once.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with an NVIDIA card. Without
a card (or with fewer than the cell asks for) it exits 1 and prints no
result.

Set-up: the cell's frames are made on the card from ``--seed``
(``frames.py``), the decode phase's streams by the reference encoder
(``reference/``), and the program's encoder and decoder warmed up on
both; Python's bytecode is kept in the checkout (``PYCACHE``), so that
only a checkout's first run compiles torch's sources. ``setup_s`` runs
from the process's start to the first timed call, less the seconds the
reference spent on those streams, which only the judge's side of the
run needs.
The window: an encode phase of ``--seconds / 2`` and a decode phase of
as long, each a closed loop with one call in flight (``window.py``).
After it: the peak of device memory, a check that no module of JAX or
of the JAX package was loaded, then the judge (``judge.py``) on streams
and decoded frames drawn from the seed. Standard error carries each phase's medians and counts, the set-up's parts and a
calibration of the host's speed around the window and, last,
each number compared beside its limit; the last line of standard output
is the result as one JSON object. With ``--trace 1`` the first
``trace.TRACE_SECONDS`` of each phase run under ``torch.profiler`` and
the metrics are the per-layer ones (``metrics/``).
"""
from __future__ import annotations

import gc
import os
import sys
import time
import types

#: the process's age at import, for ``setup_s``
_T_IMPORT = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
#: every build and kernel cache of the program, at fixed paths in the
#: checkout, so that only a checkout's first run builds
CACHE = os.path.join(HERE, ".cache")
CACHE_ENV = {
    "GPUJPEG_TPU_TORCH_BUILD_DIR": "kernels",
    "GPUJPEG_TPU_TORCH_NATIVE_CACHE": "native",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
}
#: Python's bytecode, at a fixed path in the checkout: where the
#: environment turns the writing of bytecode off (PYTHONDONTWRITEBYTECODE)
#: and the installed packages ship none, every run would compile torch's
#: 2,000 sources anew, seconds of the host's CPU that swing with its load
PYCACHE = os.path.join(CACHE, "pycache")
#: top-level modules that the process must not hold after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "gpujpeg_tpu")


def process_age() -> float:
    """Seconds since this process started (``/proc``; the time since this
    module's import where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def use_cache_dirs() -> None:
    """Point the program's build and kernel caches at :data:`CACHE`."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], mode=0o700, exist_ok=True)


def use_bytecode_cache() -> None:
    """Compile each module that the run imports once in a checkout, and
    keep its bytecode under :data:`PYCACHE` for the runs after it."""
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load(name: str):
    from .spec import load_cell
    return load_cell(name)


def _keep_every(seed: int, expected: int, want: int):
    """A draw from ``seed`` of about ``want`` call indices spread over
    ``expected`` calls: gaps uniform on 1 .. 2g - 1, g = expected / want."""
    import random
    rng = random.Random(seed)
    g = max(1, expected // max(1, want))
    picks, i = set(), rng.randrange(g)
    while i < 4 * expected + 4 * want:
        picks.add(i)
        i += rng.randint(1, 2 * g - 1) if g > 1 else 1
    return picks.__contains__


def calibrate_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed at the
    moment, printed beside each run so that slow minutes show."""
    t = time.perf_counter()
    x = 0
    for i in range(200_000):
        x += i
    return (time.perf_counter() - t) * 1e3


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             make_coders=None) -> tuple[dict, list]:
    """One run of ``cell``: (the result object, the lines for standard
    error). ``make_coders`` puts a stand-in in the program's place (see
    ``control.py``)."""
    import numpy as np
    import torch

    from . import frames, judge, window
    from .program import Program
    from .reference.geometry import make_geometry
    from .spec import reader
    from .trace import TRACE_SECONDS, Tracer, reduce, top

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    geo = make_geometry(cfg["width"], cfg["height"], cfg["sampling"],
                        cfg["interleaved"], cfg["restart_interval"],
                        cfg["color_space_internal"] == "RGB")
    lines = []

    # set-up: frames, the decode phase's streams, the coders, warm-up
    parts = {"imports": process_age()}
    t = time.perf_counter()
    pool = frames.make_pool(cfg, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["context and frames"] = time.perf_counter() - t
    t = time.perf_counter()
    dep = judge.Deployment(cfg, geo)
    streams = [dep.stream(f) for f in pool]
    reference_s = time.perf_counter() - t
    t = time.perf_counter()
    if traffic["input"] == "device":
        inputs = pool
    else:   # pageable host memory, NumPy's own; the card keeps no copy
        inputs = [np.empty(f.numel(), np.uint8) for f in pool]
        for a, f in zip(inputs, pool):
            torch.from_numpy(a).copy_(f)
        pool = [torch.from_numpy(a) for a in inputs]
    coders = (make_coders or Program)(cfg, traffic, dev, trace, dep)
    parts["host copies and coders"] = time.perf_counter() - t
    per_call = {}
    for name, call, arg in (("encode", coders.encode, inputs[0]),
                            ("decode", coders.decode, streams[0])):
        t = time.perf_counter()
        for _ in range(cfg["warmup_calls"]):
            call(arg)
        per_call[name] = (time.perf_counter() - t) / cfg["warmup_calls"]
    tracers = {}
    if trace:
        warm = Tracer(0.0)      # the profiler's first start is slow
        warm.start()
        warm.stop()
        tracers = {p: Tracer(TRACE_SECONDS) for p in ("encode", "decode")}
    # the answers judged: a draw from the seed of each phase's calls (a
    # window that kept every answer would make the program fault in fresh
    # memory on every call)
    keep = {name: _keep_every(seed + k, int(seconds / 2 / max(t, 1e-4)),
                              cfg["judge_frames"])
            for k, (name, t) in enumerate(per_call.items())}
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_age() - reference_s
    parts["warmup"] = setup_s - sum(parts.values())
    speed = [calibrate_ms()]

    # the window
    P, px = len(pool), cfg["width"] * cfg["height"]
    phases = {}
    for name, call, stats in (
            ("encode", lambda i: coders.encode(inputs[i]),
             coders.encode_stats),
            ("decode", lambda i: coders.decode(streams[i]),
             coders.decode_stats)):
        tr = tracers.get(name)
        gc.collect()    # the harness's objects stay out of the phase's GC
        gc.freeze()
        if tr:
            tr.start()
        phases[name] = window.run_phase(
            name, call, P, seconds / 2, px, keep=keep[name],
            after=stats if trace else None,
            on_tick=tr.tick if tr else None)
        if tr:
            tr.stop()
    gc.unfreeze()
    speed.append(calibrate_ms())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    coders.close()
    del coders
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")
    traces = {}
    for name, tr in tracers.items():
        host, devev = tr.events()
        traces[name] = reduce(host, devev, "portbench." + name)
        tr.prof = None

    # the judge
    enc, dec = phases["encode"], phases["decode"]
    uniq = {}
    for i, s in enumerate(enc.results):
        if s is not None and s is not False:
            uniq.setdefault((i % P, s), None)
    outs = [(i % P, o) for i, o in enumerate(dec.results)
            if o is not None and o is not False]
    frames_of = dict(enumerate(pool))
    t = time.perf_counter()
    dep.counts = dict.fromkeys(dep.counts, 0)
    numbers = {"enc_worst_miss": judge.worst_miss(dep, list(uniq),
                                                  frames_of, dev)}
    numbers["dec_worst_miss"] = judge.decode_miss(dep, outs, frames_of, dev)
    judge_s = time.perf_counter() - t
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    failed = enc.failed + dec.failed
    correct = failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    # metrics
    run = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, geo=geo, phases=phases, traces=traces,
        setup_s=setup_s, stream_bytes={
            "encode": sum(len(s) for _, s in uniq) / max(1, len(uniq)),
            "decode": sum(map(len, streams)) / len(streams)})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": enc.calls + dec.calls,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        got = [t for t in traces.values() if t]
        device_info["busy_s"] = sum(t["busy_s"] for t in got)
        device_info["window_s"] = sum(t["window_s"] for t in got)
        ops, gaps = {}, {}
        for t in got:
            for k, v in t["ops"].items():
                ops[k] = ops.get(k, 0.0) + v
            for k, v in t["gaps"]:
                gaps[k] = gaps.get(k, 0.0) + v
        result["breakdown"] = {"device_ops": top(ops), "idle_gaps": top(gaps)}
    result["checks"] = checks

    for ph in phases.values():
        lat = ph.latencies_ms()
        lines.append(
            f"{ph.name}: {ph.calls} calls ({ph.failed} failed) in "
            f"{ph.span_s:.3f} s, {window.mpix_s(ph)} Mpix/s; latency ms "
            f"median {float(np.median(lat))}, p95 "
            f"{window.percentile_ms(ph, 95)}, min {float(lat.min())}, max "
            f"{float(lat.max())}")
    lines.append(f"setup_s {setup_s:.3f} (" + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) +
        f"; the reference's streams {reference_s:.3f}, not counted); "
        f"memory_peak_bytes {peak}; judged {len(uniq)} distinct streams, "
        f"{len(outs)} frames")
    lines.append(f"judge {judge_s:.3f} s; the reference's decode: "
                 + ", ".join(f"{v} {k}" for k, v in dep.counts.items()))
    lines.append(f"calibration: a fixed Python loop took {speed[0]:.2f} ms "
                 f"before the window, {speed[1]:.2f} ms after it")
    for k, c in checks.items():
        lines.append(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result, lines


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description="Run one cell of the benchmark "
                                "of gpujpeg_tpu_torch once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    use_bytecode_cache()
    use_cache_dirs()
    cell = load(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    log(f"card: {card_line()}")
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
