"""The readers of the lane route's metrics: ``dec.lane_rounds`` (the
program's ``gpujpeg.dec.rounds`` counter, mean a call) and
``dec.lanes_roofline`` (the lane stage's bound over the lane kernels'
device time). On a synthetic trace and span list, None where the program
records no such counter or launched no lane kernel (as the program before
the lane route), then a traced run of ``photo12m.device`` on the CPU on
the small copy: the rounds reported, the roofline left out (no device
trace on the CPU)."""
import types

import pytest

from conftest import SMALL, copy_bench
from portbench import run, spec
from portbench.reference.geometry import make_geometry
from portbench.window import Phase

ROOFLINE, ROUNDS = "dec.lanes_roofline", "dec.lane_rounds"
CELL = "photo12m.device"


def fake_run(ops: dict, calls: int = 4, stream_bytes: float = 1e6):
    geo = make_geometry(4032, 3024, [[2, 2], [1, 1], [1, 1]], True, 0)
    return types.SimpleNamespace(
        geo=geo, stream_bytes={"decode": stream_bytes},
        traces={"decode": {"ops": ops, "calls": calls, "kernel_s": 1.0,
                           "busy_s": 1.0, "window_s": 2.0}})


def test_roofline_over_the_lane_kernels_alone():
    ops = {"(anonymous namespace)::huffman_lanes_settle(LaneGeo, ...)": 2e-3,
           "(anonymous namespace)::huffman_lanes_scan(LaneGeo, int*)": 1e-4,
           "(anonymous namespace)::huffman_lanes_write(LaneGeo, ...)": 9e-4,
           "(anonymous namespace)::idct_planes_kernel(...)": 5.0}
    r = fake_run(ops)
    mod = spec.reader(ROOFLINE)
    got = mod(r)
    # 1 MB read and 285,768 blocks of 64 two-byte coefficients written, at
    # 3.35 TB/s, 4 calls over 3 ms of lane kernels
    want = 100 * 4 * (1e6 + 285_768 * 128) / 3.35e12 / 3e-3
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_roofline_none_without_lane_kernels():
    read = spec.reader(ROOFLINE)
    assert read(fake_run({"huffman_decode_kernel(...)": 1e-3})) is None
    r = fake_run({})
    r.traces = {}
    assert read(r) is None


def _span_run(monkeypatch, names, calls):
    """A run whose decode phase holds ``calls``: each (rounds or None)."""
    import numpy as np

    from portbench import spans
    SPAN = np.dtype([("name", np.int16), ("parent", np.int32),
                     ("call", np.int64), ("start_ns", np.int64),
                     ("end_ns", np.int64), ("bytes", np.int64)])
    rows = []
    for k, rounds in enumerate(calls):
        t0 = (1000 + 10 * k) * 1_000_000
        r = len(rows)
        rows.append((names.index("gpujpeg.dec"), -1, k, t0, t0 + 5_000_000,
                     0))
        if rounds is not None:
            rows.append((names.index("gpujpeg.dec.rounds"), r, k,
                         t0 + 4_000_000, t0 + 4_000_000, rounds))
    fake = types.SimpleNamespace(NAMES=tuple(names),
                                 spans=lambda: np.array(rows, SPAN),
                                 dropped=lambda: 0)
    monkeypatch.setattr(spans, "source", lambda: fake)
    ph = Phase("decode", 1)
    ph.starts, ph.ends = [1.0], [1.0 + 0.01 * len(calls)]
    return types.SimpleNamespace(phases={"decode": ph})


def test_rounds_mean_a_call(monkeypatch):
    names = ["gpujpeg.dec", "gpujpeg.dec.rounds"]
    r = _span_run(monkeypatch, names, [9, 11, 10])
    assert spec.reader(ROUNDS)(r) == pytest.approx(10)


def test_rounds_none_for_a_program_without_the_counter(monkeypatch):
    r = _span_run(monkeypatch, ["gpujpeg.dec", "gpujpeg.dec.rounds"],
                  [None, None])
    assert spec.reader(ROUNDS)(r) is None


@pytest.fixture
def photo_root(tmp_path):
    return copy_bench(str(tmp_path), {**SMALL,
                                      "photo_12m_420_q92_rst0": (136, 200)})


def test_traced_cell_on_the_cpu_reports_the_rounds(photo_root, monkeypatch):
    """The real program on the CPU, the cell cut to 200x136, every frame on
    the device route: the rounds are read, the roofline is left out."""
    import gpujpeg_tpu_torch.models.decoder as dmod
    from gpujpeg_tpu_torch import trace
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    trace.clear()
    cell = spec.load_cell(CELL, photo_root)
    assert {ROOFLINE, ROUNDS} <= {m["name"] for m in cell.per_layer}
    try:
        result, _ = run.run_cell(cell, 2 ** 31 + 7, 1.0, True, device="cpu")
    finally:
        trace.clear()
    assert result["correct"]
    got = result["metrics"]
    assert got[ROUNDS]["value"] >= 1 and got[ROUNDS]["unit"] == "rounds"
    assert ROOFLINE not in got
