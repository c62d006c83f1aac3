"""The measured window: closed-loop phases of calls, one in flight, and
the arithmetic of their end-to-end metrics.

A phase calls ``call(i)`` for i = 0, 1, ... and starts no call once
``seconds`` have passed since the first call began; it ends when the
last call returns. Its rate is the pixels of every call over that whole
span, its tail the percentile of every call's latency: no call is left
out and no rate is built from chunks.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
from torch.profiler import record_function


@dataclasses.dataclass
class Phase:
    name: str
    #: pixels of one call's frame
    pixels: int
    starts: list = dataclasses.field(default_factory=list)
    ends: list = dataclasses.field(default_factory=list)
    #: calls that raised
    failed: int = 0
    #: every call's result (call i ran on pool frame i % n_pool): None
    #: where it was not kept, False where it raised
    results: list = dataclasses.field(default_factory=list)
    #: what ``after`` returned for each call (the traced run's stats)
    stats: list = dataclasses.field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.starts)

    @property
    def span_s(self) -> float:
        return self.ends[-1] - self.starts[0] if self.starts else 0.0

    def latencies_ms(self) -> np.ndarray:
        return (np.asarray(self.ends) - np.asarray(self.starts)) * 1e3


def mpix_s(phase: Phase) -> float | None:
    """Pixels of every completed call over the phase's span, in Mpix/s."""
    done = phase.calls - phase.failed
    if phase.span_s <= 0 or done <= 0:
        return None
    return done * phase.pixels / phase.span_s / 1e6


def percentile_ms(phase: Phase, q: float) -> float | None:
    """The ``q``-th percentile of every call's latency (linear between
    order statistics)."""
    lat = phase.latencies_ms()
    return float(np.percentile(lat, q)) if len(lat) else None


def run_phase(name: str, call, n_pool: int, seconds: float, pixels: int,
              keep=lambda i: True, after=None, on_tick=None) -> Phase:
    """Call ``call(i % n_pool)`` in a closed loop for ``seconds``. Keeps
    the result of call i where ``keep(i)``; ``after()`` runs after each
    call, outside its latency, and its value is kept in ``stats``;
    ``on_tick(elapsed)`` runs between calls."""
    ph = Phase(name, pixels)
    clock = time.perf_counter
    first = None
    i = 0
    while True:
        t0 = clock()
        if first is None:
            first = t0
        elif t0 - first >= seconds:
            break
        idx = i % n_pool
        try:
            with record_function("portbench." + name):
                out = call(idx)
        except Exception:    # the window goes on; the call counts failed
            out = False
            ph.failed += 1
            if ph.failed == 1:
                traceback.print_exc(file=sys.stderr)
        t1 = clock()
        ph.starts.append(t0)
        ph.ends.append(t1)
        ph.results.append(out if out is False or keep(i) else None)
        if after is not None:
            ph.stats.append(after())
        if on_tick is not None:
            on_tick(t1 - first)
        i += 1
    return ph
