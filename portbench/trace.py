"""The traced run's reading of the device: ``torch.profiler`` over the
first seconds of each phase, reduced to what the per-layer metrics and
the ``breakdown`` read. Nothing is written to disk.

Device activity is every event the profiler records on the card:
kernels, copies and sets, but not the shadows of the host's spans that
it also draws there. A phase's traced window runs from the start of
its first traced call to the end of its last (the harness's
``portbench.<phase>`` spans); the card is busy where any device event
runs, idle elsewhere. An idle gap is named by the harness span and the
innermost host operation under way at its middle.
"""
from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: seconds at the start of each phase that a traced run profiles
TRACE_SECONDS = 3.0
#: characters of a name kept in the breakdown
NAME_CHARS = 96
#: idle gaps named a phase
GAPS = 10


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Tracer:
    """Profiles a phase from its first call until ``seconds`` have passed
    (checked between calls)."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.active = False

    def start(self) -> None:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.active = True

    def tick(self, elapsed: float) -> None:
        if self.active and elapsed >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.active:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.active = False

    def events(self) -> tuple[list, list]:
        """(host events, device events) as (start ns, end ns, name)."""
        host, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() != DeviceType.CUDA:
                host.append(rec)
            elif not e.is_user_annotation():   # a span's shadow on the card
                dev.append(rec)
        return host, dev


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(host: list, dev: list, span: str) -> dict | None:
    """The phase's traced window: its length, the card's busy time, the
    kernels' summed time, the traced calls, device time by operation name
    and the idle gaps by name (seconds); None without a traced call."""
    calls = [(s, e) for s, e, n in host if n == span]
    if not calls:
        return None
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev
              if e > w0 and s < w1]
    busy = _merge([[s, e] for s, e, _ in inside if e > s])
    ops: dict = {}
    for s, e, n in inside:
        ops[n[:NAME_CHARS]] = ops.get(n[:NAME_CHARS], 0.0) + (e - s) * 1e-9
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:GAPS]:
        mid = (g0 + g1) // 2
        under = [(s, e, n) for s, e, n in host if s <= mid < e]
        inner = [n for s, e, n in sorted(under, key=lambda x: (x[0], -x[1]))
                 if n != span]
        where = span if any(n == span for *_, n in under) else "between calls"
        named.append((f"{where}/{inner[-1] if inner else 'python'}"
                      [:NAME_CHARS], (g1 - g0) * 1e-9))
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernel_s": sum(e - s for s, e, n in inside if is_kernel(n)) * 1e-9,
        "calls": len(calls),
        "ops": ops,
        "gaps": named,
    }


def top(items: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a name -> seconds map, as pairs."""
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            [:n]]
