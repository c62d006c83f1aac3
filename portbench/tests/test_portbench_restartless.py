"""Deployments without restart markers (restart interval 0): a baseline
stream with no DRI and one entropy segment a scan, as libjpeg's
``cjpeg`` writes by default. The reference's geometry against the
program's plan, its streams and their parsing, its chunked decode of long
segments against the decode of each segment whole, and a run of the
harness: the program correct, the control and each fault not. On the CPU,
on the small copy of the benchmark with a trial configuration and cell
written into it alone."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import SMALL, copy_bench
from portbench import frames, judge, run, spec
from portbench.control import FAULTS, Control
from portbench.program import Program
from portbench.reference import codec, geometry

#: the trial deployment, cut to a small frame: RGB to 4:2:0 interleaved,
#: Q92, no restart markers (libjpeg's defaults)
TRIAL = {
    "source": "libjpeg cjpeg defaults: -sample 2x2, no -restart",
    "deployment": "A photo without restart markers, RGB in and out.",
    "reduced": [], "assumed": {},
    "width": 200, "height": 136, "pixel_format": "PF_444_U8_P012",
    "color_space": "RGB", "color_space_internal": "YCBCR_BT601_256LVLS",
    "sampling": [[2, 2], [1, 1], [1, 1]], "interleaved": True,
    "quality": 92, "restart_interval": 0,
    "output_pixel_format": "PF_444_U8_P012", "output_color_space": "RGB",
    "dct_precision": "float32", "pool_frames": 3, "pan_px": 0,
    "warmup_calls": 1, "judge_frames": 3,
    "limits": {"enc_worst_miss": 0.001, "dec_worst_miss": 0.0006}}
CELL = "trial.host"
SEED = 2 ** 31 + 4243
#: (sampling, interleaved) of the geometries held against the plan
LAYOUTS = {"420i": ([[2, 2], [1, 1], [1, 1]], True),
           "422n": ([[2, 1], [1, 1], [1, 1]], False),
           "444n": ([[1, 1], [1, 1], [1, 1]], False)}


@pytest.fixture
def trial_root(tmp_path):
    root = copy_bench(str(tmp_path), SMALL)
    with open(os.path.join(root, "portbench", "configs", "trial.json"),
              "w") as f:
        json.dump(TRIAL, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "trial", "source": TRIAL["source"],
                             "file": "portbench/configs/trial.json",
                             "reduced": [], "why": "no restart markers"})
    bench["workloads"].append({"name": CELL, "config": "trial",
                               "traffic": "host", "chips": 1,
                               "why": "no restart markers"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def trial_geometry(cfg=TRIAL):
    return geometry.make_geometry(cfg["width"], cfg["height"],
                                  cfg["sampling"], cfg["interleaved"],
                                  cfg["restart_interval"])


def trial_streams(n=3, seed=2 ** 33 + 1, size=None):
    """``n`` frames of the trial deployment, or of it cut to ``size``
    (height, width), with the reference's streams of them."""
    cfg = TRIAL if size is None else {**TRIAL, "height": size[0],
                                      "width": size[1]}
    geo = trial_geometry(cfg)
    dep = judge.Deployment(cfg, geo)
    pool = frames.make_pool(cfg, seed, "cpu")[:n]
    return geo, dep, pool, [dep.stream(f) for f in pool]


def scan_of(stream: bytes) -> int:
    """First byte of the (last) scan's entropy data."""
    sos = stream.rfind(b"\xff\xda")
    return sos + 2 + int.from_bytes(stream[sos + 2:sos + 4], "big")


def middle(stream: bytes) -> int:
    """A byte about the middle of the scan, neither 0xFF nor after one,
    where bytes can change without making a marker."""
    i = (scan_of(stream) + len(stream) - 2) // 2
    while 0xFF in stream[i - 1:i + 1]:
        i += 1
    return i


@pytest.mark.parametrize("ri", [0, 1, 3, 32])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_geometry_equals_the_programs_plan(layout, ri):
    """Every interval, 0 among them (one segment a scan, the DC predictor
    across the whole scan), gives the program's plan."""
    from gpujpeg_tpu_torch.plan import make_plan
    sampling, interleaved = LAYOUTS[layout]
    cfg = {**TRIAL, "sampling": sampling, "interleaved": interleaved,
           "restart_interval": ri}
    geo = trial_geometry(cfg)
    prog = Program(cfg, {"output": "host"}, "cpu", False)
    plan = make_plan(prog.params, prog.image)
    assert (plan.block_plane_idx == geo.block_plane_idx).all()
    assert (plan.block_comp == geo.block_comp).all()
    assert (plan.dc_pred_idx == geo.dc_pred).all()
    assert (plan.seg_block_start == geo.seg_start).all()
    assert (plan.seg_block_count == geo.seg_count).all()
    if ri == 0:
        assert geo.n_segments == len(geo.scans)
        assert (geo.dc_pred >= 0).sum() == geo.n_blocks - sum(
            len(s) for s in geo.scans)


def test_stream_without_dri_parses():
    geo, dep, _, streams = trial_streams(1)
    s = streams[0]
    assert b"\xff\xdd" not in s[:scan_of(s)]
    assert len(codec.parse(s, geo).seg_bits) == 1
    sof = s.index(b"\xff\xc0")
    for ri, ok in ((0, True), (2, False)):
        dri = codec._marker(0xDD, ri.to_bytes(2, "big"))
        with_dri = s[:sof] + dri + s[sof:]
        if ok:
            assert codec.parse(with_dri, geo).seg_bits.tolist() \
                == codec.parse(s, geo).seg_bits.tolist()
        else:
            with pytest.raises(codec.StreamError, match="restart interval"):
                codec.parse(with_dri, geo)
    # an interval-N deployment still asks for DRI N
    geo4 = trial_geometry({**TRIAL, "restart_interval": 4})
    with pytest.raises(codec.StreamError, match="restart interval None"):
        codec.parse(s, geo4)
    # a restart marker inside a scan of an interval-0 deployment
    mid = middle(s)
    with pytest.raises(codec.StreamError, match="segments in a scan"):
        codec.parse(s[:mid] + b"\xff\xd0" + s[mid:], geo)


def test_reference_stream_through_the_programs_host_route():
    """The program's host route decodes the reference's streams to the
    reference's pixels, and the reference decodes them to its own
    coefficients."""
    geo, dep, pool, streams = trial_streams()
    prog = Program(TRIAL, {"output": "host"}, "cpu", False)
    outs = [(i, prog.decode(s)) for i, s in enumerate(streams)]
    frames_of = dict(enumerate(pool))
    assert judge.decode_miss(dep, outs, frames_of, "cpu") == 0.0
    got = dep.decode(streams, "cpu")
    for f, (coeff, quant) in zip(pool, got):
        assert torch.equal(coeff, codec.coefficients(dep.planes(f), geo,
                                                     dep.quant))
    assert dep.counts["rounds"] >= 1
    assert dep.counts["lanes"] > len(streams)


def damaged(streams):
    """Each stream, and copies of it damaged: a bit flipped, a run of 48
    one-bits (no code of the tables has 16 ones, so an invalid code), the
    scan cut in half (a read past its end), 16 bits of zeros before EOI
    (more than 7 bits of padding left)."""
    out = []
    for s in streams:
        mid, b = middle(s), len(s) - 2
        flip = bytearray(s)
        flip[mid] ^= 0x10 if s[mid] != 0xEF else 0x01
        out += [s, bytes(flip),
                s[:mid] + b"\xff\x00" * 6 + s[mid + 6:],
                s[:mid] + b"\xff\xd9",
                s[:b] + b"\x00\x00" + s[b:]]
    return out


def parsed(streams, geo):
    out = []
    for s in streams:
        try:
            out.append(codec.parse(s, geo))
        except codec.StreamError:
            pass
    return out


@pytest.mark.parametrize("chunk_bits", [5, 13, 100, 1024, 10 ** 9])
def test_chunked_decode_equals_whole_segments(chunk_bits):
    """The decode in chunks, from chunks that start inside a code or its
    extra bits (5, 13 bits) to one chunk a segment, equals the decode of
    each segment whole, on sound and damaged streams alike."""
    geo, _, _, streams = trial_streams(
        2, size=(56, 72) if chunk_bits < 100 else None)
    ps = parsed(damaged(streams), geo)
    whole = codec.decode_segments(ps, geo, "cpu", chunk_bits=0)
    got = codec.decode_segments(ps, geo, "cpu", chunk_bits=chunk_bits)
    assert torch.equal(whole[0], got[0]) and torch.equal(whole[1], got[1])
    assert whole[2]["rounds"] == 0 and whole[2]["lanes"] == len(ps)
    if chunk_bits < 1000:
        assert got[2]["lanes"] > len(ps) and got[2]["rounds"] >= 1


def test_damaged_segments_fail():
    """An invalid code, a truncated scan and padding of more than 7 bits
    each read as a failed segment of zeros; the sound stream and the one
    with a bit flipped decode."""
    geo, _, _, streams = trial_streams(1)
    ps = parsed(damaged(streams), geo)
    assert len(ps) == 5
    coeff, ok, counts = codec.decode_segments(ps, geo, "cpu")
    assert ok[:, 0].tolist() == [True, ok[1, 0].item(), False, False, False]
    assert counts["rounds"] >= 1
    assert not coeff[2:].any()
    assert coeff[0].any()


def one_run(root, make, seconds=0.5):
    cell = spec.load_cell(CELL, root)
    result, lines = run.run_cell(cell, SEED, seconds, False, device="cpu",
                                 make_coders=make)
    assert lines[-1].startswith("check dec_worst_miss")
    assert any(line.startswith("judge ") for line in lines)
    return result


def test_program_is_correct(trial_root):
    res = one_run(trial_root, None)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_is_not_correct(trial_root, kind):
    res = one_run(trial_root, FAULTS[kind])
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_control_is_not_correct(trial_root):
    res = one_run(trial_root, Control, seconds=1.0)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_dc_values_follow_the_predictors():
    """The DC sums equal a walk along ``dc_pred``, at every interval."""
    for ri in (0, 1, 3):
        geo = trial_geometry({**TRIAL, "restart_interval": ri})
        diff = torch.as_tensor(np.random.default_rng(ri).integers(
            -50, 50, (2, geo.n_blocks)))
        want = diff.clone()
        for b in range(geo.n_blocks):     # a predictor comes before
            if geo.dc_pred[b] >= 0:
                want[:, b] += want[:, geo.dc_pred[b]]
        assert torch.equal(codec._dc_values(diff, geo), want)
