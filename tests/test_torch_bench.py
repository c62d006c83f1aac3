"""The port's bench entry points (``gpujpeg_tpu_torch.tools.bench``,
``.bench_suite``, ``.perf_host``) on the CPU against the JAX package's
``bench.py``, ``bench_suite.py`` and ``scripts/perf_host.py``: the same
frame, constants and restart intervals, the same line and row keys, and
streams equal to the JAX encoder's (its Pallas kernels in interpret
mode)."""
import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu_torch.models.decoder import plan_from_info
from gpujpeg_tpu_torch.models.encoder import Encoder
from gpujpeg_tpu_torch.ops import pipeline
from gpujpeg_tpu_torch.ops.decode import build_rows
from gpujpeg_tpu_torch.stream.reader import read_image
from gpujpeg_tpu_torch.tools import bench, bench_frame, bench_suite, perf_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: bench.py's line keys that the port's line keeps
JAX_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "decode_device_ms",
                 "decode_wall_ms", "first_iteration_s",
                 "first_iteration_inproc_s"}
#: the port's line's time keys (null on the CPU)
TIME_KEYS = ("value", "vs_baseline", "decode_device_ms", "decode_wall_ms",
             "first_iteration_s", "first_iteration_inproc_s",
             "first_iteration_cold_s", "encode_e2e_ms", "decode_e2e_ms")


def _root_module(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _suite_ast():
    """bench_suite.py's syntax tree (importing it sets JAX's cache dir)."""
    with open(os.path.join(ROOT, "bench_suite.py")) as f:
        return ast.parse(f.read())


def _suite_constant(name):
    for node in _suite_ast().body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _suite_row_keys(fn_name):
    """The keys bench_suite.py's ``fn_name`` puts in ``row``: ``dict(...)``
    assigned to it, ``row.update(...)`` and ``row["k"] = ...``."""
    fn = next(n for n in ast.walk(_suite_ast())
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if getattr(t, "id", None) == "row" and isinstance(
                    node.value, ast.Call) and getattr(
                    node.value.func, "id", None) == "dict":
                keys |= {k.arg for k in node.value.keywords}
            if isinstance(t, ast.Subscript) and getattr(
                    t.value, "id", None) == "row":
                keys.add(t.slice.value)
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "row"):
            keys |= {k.arg for k in node.keywords}
    return keys


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, with fresh
    executable caches (as tests/test_torch_encode.py runs them)."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    ref_jp._ENC_CACHE.clear()
    yield
    ref_jp._ENC_CACHE.clear()


def _jax_stream(img, quality, ri):
    """(the JAX encoder's stream of ``img`` as the bench configures it,
    its encode kind)."""
    H, W, _ = img.shape
    image = ref.ImageParameters(width=W, height=H,
                                color_space=ref.ColorSpace.RGB,
                                pixel_format=ref.PixelFormat.PF_444_U8_P012)
    params = ref.Parameters(quality=quality, restart_interval=ri,
                            interleaved=False)
    enc = ref.Encoder(backend="jax")
    data = enc.encode(img, params, image)
    ctx = ref_jp._enc_context(ref_make_plan(params, image),
                              *enc._tables(params))
    return data, ctx.fn.kind


@pytest.mark.parametrize("h,w", [(8, 8), (45, 37), (64, 96), (130, 200)])
def test_bench_frame_equals_bench_make_image(h, w):
    make_image = _root_module("bench").make_image
    np.testing.assert_array_equal(bench_frame(h, w), make_image(h, w))
    np.testing.assert_array_equal(bench_frame(h, w, seed=3),
                                  make_image(h, w, seed=3))


@pytest.mark.parametrize("band_rows", [1, 7, 16, 44, 45, 512])
def test_banded_bench_frame_equals_the_whole_frame(band_rows):
    """The frame built in bands of rows (uneven: 45 rows in bands of 7, the
    last 3) drawn from one generator in row order gives the bytes of the
    frame built at once."""
    whole = bench_frame(45, 37, band_rows=45)
    np.testing.assert_array_equal(bench_frame(45, 37, band_rows=band_rows),
                                  whole)
    np.testing.assert_array_equal(whole, _root_module("bench").make_image(
        45, 37))


@pytest.mark.parametrize("name", list(bench_suite.RES))
def test_restart_interval_equals_the_jax_suggestion(name):
    H, W = bench_suite.RES[name]
    kw = dict(width=W, height=H, pixel_format=ref.PixelFormat.PF_444_U8_P012)
    for q in [None] + list(bench_suite.SWEEP_QUALITIES):
        want = ref.suggest_restart_interval(
            ref.ImageParameters(**kw), subsampled=False, interleaved=False,
            pow2=True, quality=q)
        image, params = bench.config(H, W, q or 75, quality_clamp=q is not None)
        assert (image.width, image.height) == (W, H)
        assert params.restart_interval == want, (name, q)
        assert port.suggest_restart_interval(
            image, subsampled=False, interleaved=False, pow2=True,
            quality=q) == want


def test_suite_constants_equal_bench_suite_py():
    for name in ("RES", "BASE_ENC", "BASE_DEC"):
        assert getattr(bench_suite, name) == _suite_constant(name), name


def test_bench_on_cpu_line_and_stream(interpret, monkeypatch, capsys):
    """The bench at 256x256 on the plain versions, with the 8K interval
    (32: 96 segments, so the decode takes the device route, and the JAX
    encoder takes K1): exit 0, every key of the line, every time null,
    and the stream equal to the JAX encoder's K1 stream."""
    monkeypatch.setattr(bench, "suggest_restart_interval",
                        lambda *a, **k: 32)
    monkeypatch.setenv("BENCH_ITERS", "2")
    line, stream = bench.main(["--device", "cpu", "--height", "256",
                               "--width", "256"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert tuple(line) == bench.LINE_KEYS
    assert JAX_LINE_KEYS <= set(line)
    assert all(line[k] is None for k in TIME_KEYS)
    assert line["card"] == "cpu" and line["backend"] == "torch"
    assert line["launches"]["runs"] == 3
    assert "route gate: held" in err and "BENCH FAIL" not in err
    assert "restart interval 32" in err
    expect, kind = _jax_stream(bench_frame(256, 256), 75, 32)
    assert kind == "fused_full_words"
    assert stream == expect


def test_route_gate_fails_off_e1(monkeypatch, capsys):
    """With the encode forced off E1 -> E2 -> E3 (onto E0 + E1p), the bench
    prints its line and BENCH FAIL and exits 1."""
    monkeypatch.setattr(pipeline, "rgb_eligible", lambda plan: False)
    monkeypatch.setattr(bench, "first_call_subprocess",
                        lambda *a, **k: 0.0)
    monkeypatch.setenv("BENCH_ITERS", "1")
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--height", "64", "--width", "96"])
    assert e.value.code == 1
    out, err = capsys.readouterr()
    assert "BENCH FAIL: the encode did not take its route" in err
    assert set(json.loads(out.strip().splitlines()[-1])) == set(
        bench.LINE_KEYS)


def test_route_gate_counts_on_the_card():
    """On a CUDA device the gate also holds each kernel of the route to
    its launches a run (the CPU's plain versions launch nothing)."""
    cuda = torch.device("cuda")
    runs = 4
    good = {k.__name__: n * runs for k, n in bench.ENCODE_ROUTE.items()}
    assert bench.route_failures("e", bench.ENCODE_ROUTE, good, runs, True,
                                cuda) == []
    assert bench.route_failures("e", bench.ENCODE_ROUTE, good, runs, True,
                                CPU) == []
    for name in good:
        bad = dict(good, **{name: good[name] + 1})
        assert len(bench.route_failures("e", bench.ENCODE_ROUTE, bad, runs,
                                        True, cuda)) == 1
    assert len(bench.route_failures("e", bench.ENCODE_ROUTE, good, runs,
                                    False, CPU)) == 1
    dgood = {k.__name__: n * runs for k, n in bench.DECODE_ROUTE.items()}
    assert dgood == {"huffman_decode": 4, "idct_rgb": 4, "idct_planes": 0,
                     "postprocess_planes": 0}
    assert bench.route_failures("d", bench.DECODE_ROUTE, dict(
        dgood, idct_planes=1), runs, True, cuda)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_suite.main(["--device", "cuda", "--no-16k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_suite.bench_res("HD", 1)


def test_suite_rows_on_cpu(interpret, monkeypatch, capsys):
    """The suite's rows at 64x96: bench_suite.py's keys plus the card's,
    times null; the sweep's Q10 and Q100 streams equal to the JAX
    encoder's; the table lists the resolution and video rows."""
    size = (64, 96)
    res, _ = bench_suite.bench_res("16K", 2, "cpu", size)
    assert set(res) == _suite_row_keys("bench_res") | {
        "card", "restart_interval", "encode_peak_bytes", "max_memory"}
    assert res["card"] == "cpu" and res["encode_device_ms"] is None
    assert res["max_memory"] == Encoder.max_memory(64 * 96)
    video = bench_suite.bench_video(4, "cpu", size)
    assert set(video) == _suite_row_keys("bench_video") | {"card"}
    assert all(video[k] is None for k in video if k not in ("config",
                                                            "card"))
    img = bench_frame(*size)
    for q in (10, 100):
        row, stream = bench_suite.sweep_row(q, img, CPU, "96x64")
        assert set(row) == (_suite_row_keys("main") - {"decode_err"}) | {
            "card", "restart_interval"}
        assert row["variant"] == "E1-E3" and row["encode_device_ms"] is None
        expect, _ = _jax_stream(img, q, row["restart_interval"])
        assert stream == expect, q
    capsys.readouterr()
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setattr(bench_suite, "bench_video",
                        lambda **k: dict(config="video"))
    rows = bench_suite.main(["--device", "cpu", "--height", "64", "--width",
                             "96", "--no-16k"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("\t") == ["config", "mpix", "encode_device_ms",
                                  "decode_device_ms", "encode_mpix_s",
                                  "decode_mpix_s"]
    assert [r.split("\t")[0] for r in out[1:]] == ["HD", "4K", "8K", "video"]
    assert len(rows) == 4


def test_perf_host_stages(capsys):
    rows = perf_host.run(64, 96)
    out = capsys.readouterr().out
    for seginfo in (True, False):
        mine = [r for r in rows if r["segment_info"] is seginfo]
        assert [r["stage"] for r in mine] == [
            "encode: scan bodies from segment bytes",
            "encode: assemble (writer + seginfo patch)",
            "decode: read_image (marker parse + scan split)",
            "decode: plan + scan tables from info",
            "decode: segment ranges + concat",
            "decode: native row build",
            "decode: build_rows (ranges + rows)", "row payload"]
        assert all(r["min_ms"] <= r["mean_ms"] for r in mine[:-1])
        assert f"segment_info={seginfo} (9 segments)" in out
        image = port.ImageParameters(
            width=96, height=64, pixel_format=port.PixelFormat.PF_444_U8_P012)
        params = port.Parameters(quality=75, restart_interval=32,
                                 segment_info=seginfo)
        data = Encoder(backend="golden").encode(bench_frame(64, 96), params,
                                                image)
        plan, scan_data, segs = plan_from_info(read_image(data))
        assert mine[-1]["bytes"] == build_rows(plan, scan_data, segs).nbytes
    assert out.count("row payload: S=9 wcap=") == 2
    with pytest.raises(SystemExit):
        perf_host.main(["64"])
