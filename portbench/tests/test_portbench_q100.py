"""The configuration ``still_8k_rgb444_q100_rst64`` and its cell
``still8k_q100.host``, on the CPU at small sizes: the reference's geometry
equals the program's plan; the program comes out correct and the control
(the reference in TF32) and each planted fault not; and the three readers
that came with the cell: ``dec.segments_roofline`` (D0 and D1's device
time), ``enc.entropy_roofline`` (E2 and E3's) and ``enc.copy_back_ms``
(the program's span ``gpujpeg.enc.copy_back``) read only their own kernels
or span and return None without them, as the program before the span
does. A traced run of ``still8k.device`` on the CPU reports the copy back
and leaves the rooflines out (no device trace on the CPU)."""
import types

import numpy as np
import pytest

from conftest import SMALL, copy_bench
from portbench import run, spec
from portbench.control import FAULTS, Control
from portbench.reference.geometry import make_geometry
from portbench.window import Phase

CONFIG = "still_8k_rgb444_q100_rst64"
CELL = "still8k_q100.host"
SEED = 2 ** 31 + 4242
SEGMENTS, ENTROPY, COPY = ("dec.segments_roofline", "enc.entropy_roofline",
                           "enc.copy_back_ms")


@pytest.fixture
def q100_root(tmp_path):
    return copy_bench(str(tmp_path), {**SMALL, CONFIG: (136, 200)})


def one_run(root, make, seconds=0.5):
    cell = spec.load_cell(CELL, root)
    result, _ = run.run_cell(cell, SEED, seconds, False, device="cpu",
                             make_coders=make)
    return cell, result


def test_geometry_equals_the_programs_plan(q100_root):
    from gpujpeg_tpu_torch.plan import make_plan
    from portbench.program import Program
    cell = spec.load_cell(CELL, q100_root)
    cfg = cell.config
    assert (cfg["quality"], cfg["restart_interval"]) == (100, 64)
    geo = make_geometry(cfg["width"], cfg["height"], cfg["sampling"],
                        cfg["interleaved"], cfg["restart_interval"])
    prog = Program(cfg, cell.traffic, "cpu", False)
    plan = make_plan(prog.params, prog.image)
    assert (plan.block_plane_idx == geo.block_plane_idx).all()
    assert (plan.block_comp == geo.block_comp).all()
    assert (plan.dc_pred_idx == geo.dc_pred).all()
    assert (plan.seg_block_start == geo.seg_start).all()
    assert (plan.seg_block_count == geo.seg_count).all()
    assert geo.n_segments == plan.n_segments


def test_program_is_correct(q100_root):
    cell, res = one_run(q100_root, None)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"decode_mpix_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_is_not_correct(q100_root, kind):
    _, res = one_run(q100_root, FAULTS[kind])
    assert not res["correct"]
    assert [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


def test_control_is_not_correct(q100_root):
    _, res = one_run(q100_root, Control, seconds=1.0)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def fake_run(phase: str, ops: dict, calls: int = 4,
             stream_bytes: float = 5e7):
    geo = make_geometry(7680, 4320, [[1, 1], [1, 1], [1, 1]], False, 64)
    return types.SimpleNamespace(
        geo=geo, stream_bytes={phase: stream_bytes},
        traces={phase: {"ops": ops, "calls": calls, "kernel_s": 1.0,
                        "busy_s": 1.0, "window_s": 2.0}})


DEC_OPS = {
    "(anonymous namespace)::destuff_rows_kernel(unsigned char const*, ...)":
        1e-3,
    "(anonymous namespace)::huffman_decode_kernel(unsigned int const*, ...)":
        8e-3,
    "(anonymous namespace)::idct_rgb_kernel(int const*, ...)": 5.0,
    "(anonymous namespace)::huffman_lanes_settle(LaneGeo, ...)": 7.0,
    "Memcpy HtoD (Pageable -> Device)": 3.0}
ENC_OPS = {
    "(anonymous namespace)::huffman_blocks_kernel(int const*, int, ...)":
        6e-3,
    "(anonymous namespace)::merge_stuff_kernel(unsigned int const*, ...)":
        2e-3,
    "(anonymous namespace)::fdct_quant_kernel(unsigned char const*, ...)":
        5.0,
    "Memcpy DtoH (Device -> Pageable)": 3.0}


def test_segments_roofline_over_d0_and_d1_alone():
    got = spec.reader(SEGMENTS)(fake_run("decode", DEC_OPS))
    # 50 MB read and 1,555,200 blocks of 64 two-byte coefficients written,
    # at 3.35 TB/s, 4 calls over 9 ms of D0 and D1
    want = 100 * 4 * (5e7 + 1_555_200 * 128) / 3.35e12 / 9e-3
    assert got == pytest.approx(want) and 0 < got < 100


def test_entropy_roofline_over_e2_and_e3_alone():
    got = spec.reader(ENTROPY)(fake_run("encode", ENC_OPS))
    want = 100 * 4 * (1_555_200 * 128 + 5e7) / 3.35e12 / 8e-3
    assert got == pytest.approx(want) and 0 < got < 100


@pytest.mark.parametrize("name,phase,ops", [
    (SEGMENTS, "decode", {"(anonymous namespace)::huffman_lanes_write()": 1,
                          "idct_rgb_kernel": 1.0}),
    (ENTROPY, "encode", {"fdct_quant_kernel": 1.0, "Memcpy DtoH": 1.0})])
def test_rooflines_none_without_their_kernels(name, phase, ops):
    read = spec.reader(name)
    assert read(fake_run(phase, ops)) is None
    r = fake_run(phase, {})
    r.traces = {}
    assert read(r) is None


def _span_run(monkeypatch, names, copies):
    """A run whose encode phase holds a call for each entry of
    ``copies``: the chunks' copy back spans (start, end) in ms inside the
    call's ``gpujpeg.enc.memory_from``, where the names have the span."""
    from portbench import spans
    SPAN = np.dtype([("name", np.int16), ("parent", np.int32),
                     ("call", np.int64), ("start_ns", np.int64),
                     ("end_ns", np.int64), ("bytes", np.int64)])
    ms = 1_000_000
    rows = []
    for k, chunks in enumerate(copies):
        t0 = 1000 + 20 * k
        r = len(rows)
        rows.append((names.index("gpujpeg.enc"), -1, k, t0 * ms,
                     (t0 + 10) * ms, 0))
        m = len(rows)
        rows.append((names.index("gpujpeg.enc.memory_from"), r, k,
                     (t0 + 2) * ms, (t0 + 9) * ms, 100))
        rows.append((names.index("gpujpeg.enc.launch"), r, k, t0 * ms,
                     (t0 + 1) * ms, 0))
        for a, b in chunks:
            rows.append((names.index("gpujpeg.enc.copy_back"), m, k,
                         int((t0 + a) * ms), int((t0 + b) * ms), 50))
    fake = types.SimpleNamespace(NAMES=tuple(names),
                                 spans=lambda: np.array(rows, SPAN),
                                 dropped=lambda: 0)
    monkeypatch.setattr(spans, "source", lambda: fake)
    ph = Phase("encode", 1)
    ph.starts, ph.ends = [1.0], [1.0 + 0.02 * len(copies)]
    return types.SimpleNamespace(phases={"encode": ph})


NAMES = ["gpujpeg.enc", "gpujpeg.enc.launch", "gpujpeg.enc.memory_from",
         "gpujpeg.enc.copy_back"]


def test_copy_back_ms_reads_the_span_alone(monkeypatch):
    r = _span_run(monkeypatch, NAMES, [[(2, 3), (3, 5.5)], [(4, 5)]])
    assert spec.reader(COPY)(r) == pytest.approx((1 + 2.5 + 1) / 2)


def test_copy_back_ms_none_without_the_span(monkeypatch):
    r = _span_run(monkeypatch, NAMES, [[], []])
    assert spec.reader(COPY)(r) is None
    # a program whose tracer has no such name
    r = _span_run(monkeypatch, NAMES[:3], [[], []])
    assert spec.reader(COPY)(r) is None


def test_traced_run_on_the_cpu_reports_the_copy_back(q100_root):
    """``still8k.device`` on the CPU, traced: the copy back read from the
    program's spans, the rooflines left out (no device trace)."""
    from gpujpeg_tpu_torch import trace
    trace.clear()
    cell = spec.load_cell("still8k.device", q100_root)
    assert {COPY, ENTROPY} <= {m["name"] for m in cell.per_layer}
    try:
        result, _ = run.run_cell(cell, 2 ** 31 + 99, 1.0, True,
                                 device="cpu")
        assert trace.dropped() == 0
    finally:
        trace.clear()
    assert result["correct"]
    got = result["metrics"]
    assert got[COPY]["value"] > 0 and got[COPY]["unit"] == "ms"
    assert ENTROPY not in got and SEGMENTS not in got
