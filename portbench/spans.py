"""What the per-layer metrics of the program's spans share: the spans
that ``gpujpeg_tpu_torch.trace`` kept in one phase of the window, a frame.

A traced run holds the program's perf stats on (``program.Program``), so
every call of the window records its spans in the program's buffer, on
the clock of ``time.perf_counter``, which the window's phases read too.
A phase's spans are those of the calls whose root span starts and ends
inside ``[starts[0], ends[-1]]``: every call of the phase, the profiled
first seconds and the rest, and not the warm-up calls before it. A reader gets None where the
program has no tracer (an older program), where the buffer dropped spans,
or where the window holds no root span of the phase.
"""
from __future__ import annotations

import numpy as np

#: the root span of each phase's calls
ROOT = {"encode": "gpujpeg.enc", "decode": "gpujpeg.dec"}


def source():
    """The program's tracer module, or None where the program has none."""
    try:
        from gpujpeg_tpu_torch import trace
    except ImportError:
        return None
    return trace


def phase_spans(run, phase: str):
    """(the buffer's spans, their names, the mask of the spans of the
    phase's calls, the mask of their root spans), or None. A call is the
    phase's where its root span lies inside the phase's window."""
    trace = source()
    ph = run.phases.get(phase)
    if trace is None or trace.dropped() > 0 or ph is None or not ph.starts:
        return None
    s = trace.spans()
    names = np.asarray(trace.NAMES, dtype=object)[s["name"]]
    w0, w1 = round(ph.starts[0] * 1e9), round(ph.ends[-1] * 1e9)
    roots = ((s["parent"] == -1) & (names == ROOT[phase])
             & (s["start_ns"] >= w0) & (s["end_ns"] <= w1)
             & (s["end_ns"] >= s["start_ns"]))
    if not roots.any():
        return None
    return s, names, np.isin(s["call"], s["call"][roots]), roots


def per_frame_ms(run, phase: str, spans: tuple) -> float | None:
    """The summed duration of the phase's spans named in ``spans`` over
    the number of its root spans (its calls), ms."""
    got = phase_spans(run, phase)
    if got is None:
        return None
    s, names, inside, roots = got
    sel = inside & np.isin(names, list(spans))
    dur = (s["end_ns"][sel] - s["start_ns"][sel]).sum()
    return float(dur) * 1e-6 / int(roots.sum())


def untraced_ms(run, phase: str) -> float | None:
    """The phase's root spans' self time (a root's duration less the part
    of it that its child spans cover) over the number of roots, ms."""
    got = phase_spans(run, phase)
    if got is None:
        return None
    s, _, inside, roots = got
    root_idx = np.flatnonzero(roots)
    kids = np.flatnonzero(inside & np.isin(s["parent"], root_idx))
    kids = kids[np.lexsort((s["start_ns"][kids], s["parent"][kids]))]
    covered = 0
    parent, reach = -1, 0
    for p, a, b in zip(s["parent"][kids].tolist(),
                       s["start_ns"][kids].tolist(),
                       s["end_ns"][kids].tolist()):
        if p != parent:
            parent, reach = p, a
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    total = int((s["end_ns"][roots] - s["start_ns"][roots]).sum())
    return (total - covered) * 1e-6 / len(root_idx)
