"""The readers of the program's spans (``spans.py``, the ``program_span``
metrics that read it): on a synthetic window and span list, the mean a
frame over every call of the phase, the warm-up's spans left out, None
where spans were dropped, where the window holds no root or where the
program has no tracer, and the self time of the roots as root less the
union of their children; then a traced run of each cell on the CPU
reports each of them."""
import types

import numpy as np
import pytest

from portbench import run, spans, spec
from portbench.window import Phase

NAMES = ("gpujpeg.enc", "gpujpeg.enc.plan", "gpujpeg.enc.context",
         "gpujpeg.enc.upload", "gpujpeg.enc.launch", "gpujpeg.enc.wait",
         "gpujpeg.enc.memory_from", "gpujpeg.enc.stream",
         "gpujpeg.dec", "gpujpeg.dec.stream", "gpujpeg.dec.plan",
         "gpujpeg.dec.context", "gpujpeg.dec.rows", "gpujpeg.dec.memory_to",
         "gpujpeg.dec.launch", "gpujpeg.dec.wait", "gpujpeg.dec.memory_from")
SPAN = np.dtype([("name", np.int16), ("parent", np.int32),
                 ("call", np.int64), ("start_ns", np.int64),
                 ("end_ns", np.int64), ("bytes", np.int64)])
MS = 1_000_000      # ns
#: the new readers, by phase
ENC = ("enc.orchestration_ms", "enc.memory_from_ms", "enc.wait_ms",
       "enc.untraced_ms")
DEC = ("dec.rows_ms", "dec.memory_to_ms", "dec.orchestration_ms",
       "dec.wait_ms", "dec.untraced_ms")


class FakeTrace:
    """A stand-in for ``gpujpeg_tpu_torch.trace``: calls of (root, t0,
    [(child, start, end), ...]) in ms, laid out as the buffer lays them."""

    NAMES = NAMES

    def __init__(self, calls, dropped=0):
        rows = []
        for k, (root, t0, t1, kids) in enumerate(calls):
            r = len(rows)
            rows.append((NAMES.index(root), -1, k, t0 * MS, t1 * MS, 0))
            rows += [(NAMES.index(n), r, k, a * MS, b * MS, 0)
                     for n, a, b in kids]
        self._spans = np.array(rows, SPAN)
        self._dropped = dropped

    def spans(self):
        return self._spans

    def dropped(self):
        return self._dropped


def enc_call(t0):
    """An encode of 10 ms at ``t0`` ms: plan 1, context 1, upload 1,
    launch 2, wait 2, memory_from 1, stream 1 (ms); 1 ms untraced."""
    kids, t = [], t0
    for n, d in (("plan", 1), ("context", 1), ("upload", 1), ("launch", 2),
                 ("wait", 2), ("memory_from", 1), ("stream", 1)):
        kids.append(("gpujpeg.enc." + n, t, t + d))
        t += d
    return ("gpujpeg.enc", t0, t0 + 10, kids)


def dec_call(t0, rows=3):
    """A decode of 20 ms at ``t0`` ms: stream 2, plan 1, context 1, rows
    ``rows``, memory_to 2, launch 1, wait 4 (ms), the rest untraced."""
    kids, t = [], t0
    for n, d in (("stream", 2), ("plan", 1), ("context", 1), ("rows", rows),
                 ("memory_to", 2), ("launch", 1), ("wait", 4)):
        kids.append(("gpujpeg.dec." + n, t, t + d))
        t += d
    return ("gpujpeg.dec", t0, t0 + 20, kids)


def fake_run(enc_window, dec_window):
    """A run whose phases hold one call a window given in ms: (first
    start, last end)."""
    phases = {}
    for name, (a, b) in (("encode", enc_window), ("decode", dec_window)):
        ph = Phase(name, 1)
        ph.starts, ph.ends = [a / 1e3], [b / 1e3]
        phases[name] = ph
    return types.SimpleNamespace(phases=phases)


@pytest.fixture
def traced(monkeypatch):
    """Install a FakeTrace as the program's tracer."""
    def install(calls, dropped=0):
        fake = FakeTrace(calls, dropped)
        monkeypatch.setattr(spans, "source", lambda: fake)
        return fake
    return install


def read(name, r):
    return spec.reader(name)(r)


def test_mean_a_frame_over_the_phase_without_the_warmup(traced):
    # a warm-up call of each at 0 and 100 ms (before the windows), then
    # the encode phase 1000-1100 ms with three calls, the decode phase
    # 2000-2100 ms with two, their rows 3 and 5 ms
    traced([enc_call(0), dec_call(100, rows=40),
            enc_call(1000), enc_call(1020), enc_call(1050),
            dec_call(2000, rows=3), dec_call(2050, rows=5)])
    r = fake_run((999, 1100), (1999, 2100))
    assert read("enc.orchestration_ms", r) == pytest.approx(1 + 1 + 2)
    assert read("enc.memory_from_ms", r) == pytest.approx(1)
    assert read("enc.wait_ms", r) == pytest.approx(2)
    assert read("enc.untraced_ms", r) == pytest.approx(1)
    assert read("dec.rows_ms", r) == pytest.approx(4)
    assert read("dec.memory_to_ms", r) == pytest.approx(2)
    assert read("dec.orchestration_ms", r) == pytest.approx(1 + 1 + 1)
    assert read("dec.wait_ms", r) == pytest.approx(4)
    # 20 - (11 + 3) and 20 - (11 + 5)
    assert read("dec.untraced_ms", r) == pytest.approx(5)


def test_a_call_across_the_window_edge_is_left_out(traced):
    traced([enc_call(995), enc_call(1010), dec_call(2000)])
    r = fake_run((1000, 1030), (2000, 2020))
    assert read("enc.wait_ms", r) == pytest.approx(2)
    assert read("dec.wait_ms", r) == pytest.approx(4)


@pytest.mark.parametrize("name", ENC + DEC)
def test_none_on_dropped_spans(traced, name):
    traced([enc_call(1000), dec_call(2000)], dropped=1)
    assert read(name, fake_run((1000, 1010), (2000, 2020))) is None


@pytest.mark.parametrize("name", ENC + DEC)
def test_none_without_a_root_in_the_window(traced, name):
    traced([enc_call(0), dec_call(100)])
    assert read(name, fake_run((1000, 1010), (2000, 2020))) is None


@pytest.mark.parametrize("name", ENC + DEC)
def test_none_for_a_program_without_a_tracer(monkeypatch, name):
    monkeypatch.setattr(spans, "source", lambda: None)
    assert read(name, fake_run((1000, 1010), (2000, 2020))) is None


def test_none_for_a_program_without_the_module(monkeypatch):
    """Whether or not an earlier test imported the program: the package
    whole first, so that no test after this one finds it half imported."""
    import sys

    import gpujpeg_tpu_torch
    monkeypatch.delattr(gpujpeg_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "gpujpeg_tpu_torch.trace", None)
    assert spans.source() is None


def test_untraced_is_root_less_the_union_of_its_children(traced):
    """Children that overlap or reach past one another count once; gaps
    between them count as self time; another call's children not."""
    traced([("gpujpeg.enc", 1000, 1100, [
        ("gpujpeg.enc.plan", 1000, 1030),
        ("gpujpeg.enc.context", 1020, 1040),      # overlaps plan by 10
        ("gpujpeg.enc.upload", 1025, 1035),       # inside both
        ("gpujpeg.enc.wait", 1060, 1090)]),       # after a 20 ms gap
        ("gpujpeg.enc", 1100, 1150, [
            ("gpujpeg.enc.launch", 1110, 1150)])])
    r = fake_run((1000, 1150), (2000, 2020))
    # call 1: 100 - (40 + 30) = 30; call 2: 50 - 40 = 10
    assert read("enc.untraced_ms", r) == pytest.approx((30 + 10) / 2)
    assert read("enc.orchestration_ms", r) == pytest.approx(
        (30 + 20 + 40) / 2)


@pytest.mark.parametrize("name", ["still8k.host", "still8k.device",
                                  "video_hd.device"])
def test_traced_run_on_the_cpu_reports_them(small_root, name):
    """The real program on the CPU at small sizes, traced: each new
    metric of the cell is reported, the self time under the whole call."""
    from gpujpeg_tpu_torch import trace
    trace.clear()
    cell = spec.load_cell(name, small_root)
    want = [m["name"] for m in cell.per_layer
            if m["name"] in ENC + DEC]
    assert want
    try:
        result, _ = run.run_cell(cell, 2 ** 31 + 99, 1.0, True,
                                 device="cpu")
        assert trace.dropped() == 0
    finally:
        trace.clear()
    assert result["correct"]
    got = result["metrics"]
    for m in want:
        assert got[m]["value"] >= 0 and got[m]["unit"] == "ms", m
