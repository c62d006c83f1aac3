"""D0, the segment rows built on the card (``ops/decode.py``
``destuff_rows``, ``csrc/destuff_rows.cu``): its plain form on the CPU
against the native host row build ``gj_build_rows`` and the NumPy fallback
of ``build_segment_rows_from_ranges``, bit for bit, on segments built to
hit each rule of the destuff (FF 00 at a segment's first and last byte,
FF 00 00, FF FF 00, a 0x00 opening a segment after an 0xFF outside it,
one-byte segments, a segment of exactly ``wcap - 1`` words, missing
segments, three scans' ranges, a segment of several KB, FF 00 pairs
across the kernel's lane and step edges); the host half
(``scan_bytes``) against ``build_rows``; the decode routes: a stream with
restart markers takes D0 (the counter ``gpujpeg.dec.card_rows`` is the
plan's segments), one without takes the host's rows (no counter).

The card cases (the ``card`` fixture: they skip without a card) hold the
kernel to ``gj_build_rows`` on the same cases and on the 8K and HD bench
streams, a Q100 stream at restart interval 64 and the soak's corrupt
streams, and the decoded frames to those of the rows built on the host.
The file needs nothing of ``conftest.py``, which imports JAX, so on a
card's machine: ``python -m pytest --noconftest
tests/test_torch_destuff_rows.py -q``."""
import zlib

import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
import gpujpeg_tpu_torch.native as native
from gpujpeg_tpu_torch import trace
from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
from gpujpeg_tpu_torch.ops import decode as D
from gpujpeg_tpu_torch.ops import pipeline
from gpujpeg_tpu_torch.stream.reader import JpegParseError, read_image
from gpujpeg_tpu_torch.tools import soak


@pytest.fixture
def card():
    """The CUDA card, decided when a test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _u8(*parts) -> np.ndarray:
    return np.concatenate([np.asarray(p, np.uint8).reshape(-1)
                           for p in parts])


def _stuffed(rng, n: int, ff: float = 0.05) -> np.ndarray:
    """``n`` bytes with about a share ``ff`` of 0xFF, each followed by
    0x00 two times in three (stuffing), else by any byte."""
    b = rng.integers(0, 256, n, dtype=np.int64)
    at = np.flatnonzero(rng.random(n - 1) < ff)
    b[at] = 0xFF
    stuff = at[rng.random(at.size) < 2 / 3] + 1
    b[stuff] = 0
    return b.astype(np.uint8)


def _back_to_back(segs) -> tuple:
    """Segments laid end to end with a 2-byte marker between two:
    (data, lo, hi)."""
    data, lo, hi, at = [], [], [], 0
    for s in segs:
        lo.append(at)
        hi.append(at + len(s))
        data += [np.asarray(s, np.uint8), np.array([0xFF, 0xD0], np.uint8)]
        at += len(s) + 2
    return (_u8(*data), np.asarray(lo, np.int64), np.asarray(hi, np.int64))


def case(name: str) -> tuple:
    """(data uint8, lo int64, hi int64) of a destuff case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "ff00_first_and_last":
        return _back_to_back([[0xFF, 0x00, 0x12, 0x34, 0xFF, 0x00],
                              [0x56, 0xFF, 0x00], [0xFF, 0x00]])
    if name == "ff00_00_and_ffff00":
        return _back_to_back([[0xFF, 0x00, 0x00, 0x07],
                              [0x01, 0xFF, 0xFF, 0x00, 0x02],
                              [0xFF, 0xFF, 0x00, 0x00, 0xFF, 0x00, 0x00]])
    if name == "zero_after_outside_ff":
        data = _u8([0x11, 0xFF], [0x00, 0x00, 0x22], [0xFF], [0x00, 0x33])
        return (data, np.array([0, 2, 6], np.int64),
                np.array([2, 5, 8], np.int64))
    if name == "one_byte":
        return _back_to_back([[0xFF], [0x00], [0x5A], [0xFF, 0x00]])
    if name == "wcap_minus_one_words":
        # the longest segment, 4 m bytes and no stuffing, fills wcap - 1
        return _back_to_back([np.full(36, 0x3C), [0xFF, 0x00, 0x01],
                              _stuffed(rng, 29)])
    if name == "missing":
        data, lo, hi = _back_to_back([_stuffed(rng, 40) for _ in range(6)])
        lo[1] = hi[1] = -1                  # no segment
        hi[3] = lo[3]                       # empty
        lo[4], hi[4] = hi[4], lo[4]         # hi <= lo
        hi[5] = data.size + 3               # past the data
        return data, lo, hi
    if name == "several_kb":
        return _back_to_back([_stuffed(rng, 5000, 0.1), _stuffed(rng, 70),
                              _stuffed(rng, 3001, 0.3)])
    if name == "lane_and_step_edges":
        segs = []
        for at in (3, 4, 31, 32, 127, 128, 255, 256):
            s = np.full(300, 0x41, np.uint8)
            s[at - 1], s[at] = 0xFF, 0x00
            segs.append(s)
        return _back_to_back(segs + [np.tile([0xFF, 0x00], 200)])
    if name == "random":
        return _back_to_back([_stuffed(rng, int(n), 0.2)
                              for n in rng.integers(1, 700, 64)])
    raise KeyError(name)


CASES = ("ff00_first_and_last", "ff00_00_and_ffff00", "zero_after_outside_ff",
         "one_byte", "wcap_minus_one_words", "missing", "several_kb",
         "lane_and_step_edges", "random")


def _wanted(data, lo, hi, wcap, fallback: bool, monkeypatch=None):
    """``build_segment_rows_from_ranges``' rows as int32: the native
    ``gj_build_rows``, or with ``fallback`` its NumPy form."""
    if fallback:
        monkeypatch.setattr(native, "lib", lambda: None)
    rows = D.build_segment_rows_from_ranges(data, lo, hi, lo.size, wcap)
    if fallback:
        monkeypatch.undo()
    return torch.from_numpy(rows.view(np.int32))


def _d0(data, lo, hi, wcap, device="cpu") -> torch.Tensor:
    ranges = torch.from_numpy(np.stack([lo, hi]).astype(np.int32))
    return D.destuff_rows(torch.from_numpy(data).to(device),
                          ranges.to(device), wcap)


def _three_scans() -> tuple:
    """A non-interleaved 4:2:0 stream at restart interval 1: three scans,
    as (plan, scan data, segments by scan)."""
    h, w = 40, 56
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                    (255 - x * 5) % 256], -1).astype(np.uint8)
    p = port.Parameters(quality=97, restart_interval=1,
                        interleaved=False).with_chroma_subsampling(420)
    data = port.Encoder(backend="golden").encode(
        img.reshape(-1), p, port.ImageParameters(width=w, height=h))
    return plan_from_info(read_image(data))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("name", CASES + ("three_scans",))
def test_plain_d0_equals_the_host_row_builds(name, fallback, monkeypatch):
    """The plain D0 equals ``gj_build_rows`` and the NumPy fallback, bit
    for bit, at the row width the host route takes (:func:`D._wcap`) and,
    where a segment is longer than the row, cut as both cut it."""
    if fallback is False and native.lib() is None:
        pytest.skip("the native host codec did not build")
    if name == "three_scans":
        plan, sd, segs = _three_scans()
        assert len(sd) == 3
        data, lo, hi, wcap = D.segment_ranges_wcap(sd, segs, plan)
        assert lo.size == plan.n_segments
    else:
        data, lo, hi = case(name)
        wcap = D._wcap(lo, hi)
    got = _d0(data, lo, hi, wcap)
    assert got.dtype == torch.int32 and tuple(got.shape) == (lo.size, wcap)
    assert torch.equal(got, _wanted(data, lo, hi, wcap, fallback,
                                    monkeypatch))
    if name == "wcap_minus_one_words":
        assert (got[0, :wcap - 1] != 0).all() and (got[0, wcap - 1] == 0)
    for cut in (1, 2):
        assert torch.equal(_d0(data, lo, hi, cut), _wanted(
            data, lo, hi, cut, fallback, monkeypatch))


def test_scan_bytes_is_the_rows_host_half():
    """``scan_bytes`` keeps the scans as they lie in the stream (views, no
    copy), gives int32 ranges into them laid end to end and
    ``build_rows``' width; D0 on them gives ``build_rows``' rows, and the
    upload's layout puts the ranges on a 16-byte boundary."""
    plan, sd, segs = _three_scans()
    x = D.scan_bytes(plan, sd, segs)
    assert all(np.shares_memory(a, b) for a, b in zip(x.scans, sd))
    assert x.ranges.dtype == np.int32 and x.ranges.shape == (
        2, plan.n_segments)
    assert x.n_data == sum(s.size for s in sd)
    assert x.nbytes == x.n_data + 8 * plan.n_segments
    rows = D.build_rows(plan, sd, segs)
    assert x.wcap == rows.shape[1]
    parts, total = x.parts()
    assert [off for _, off in parts[:3]] == [0, sd[0].size,
                                             sd[0].size + sd[1].size]
    assert parts[3][1] % 16 == 0 and total == parts[3][1] + x.ranges.nbytes
    dev = pipeline.upload_scan(x, torch.device("cpu"))
    assert torch.equal(dev.data, torch.from_numpy(np.concatenate(sd)))
    assert torch.equal(dev.ranges, torch.from_numpy(x.ranges))
    assert torch.equal(D.destuff_rows(dev.data, dev.ranges, dev.wcap),
                       torch.from_numpy(rows))


@pytest.mark.parametrize("sub,interleaved,pf", [
    (444, False, "PF_444_U8_P012"), (420, True, "PF_444_U8_P012"),
    (422, False, "PF_444_U8_P012"), (420, False, "PF_444_U8_P012A"),
    (444, True, "PF_444_U8_P012A"), (444, False, "U8")])
def test_each_scans_segments_are_one_slice(sub, interleaved, pf):
    """The host half reads scan ``i``'s segments as the slice of plan
    segments from ``plan.scans[i].segment_index_start``: the segments
    whose ``seg_scan`` is ``i``, in ``seg_scan_index`` order, for 1, 3 and
    4 components, interleaved or not."""
    from gpujpeg_tpu_torch.plan import make_plan
    p = port.Parameters(quality=75, restart_interval=3,
                        interleaved=interleaved)
    if sub != 444:
        p = p.with_chroma_subsampling(sub)
    plan = make_plan(p, port.ImageParameters(
        width=75, height=41, pixel_format=getattr(port.PixelFormat, pf)))
    assert sum(sp.segment_count for sp in plan.scans) == plan.n_segments
    for i, sp in enumerate(plan.scans):
        at = np.flatnonzero(plan.seg_scan == i)
        assert np.array_equal(at, np.arange(sp.segment_count)
                              + sp.segment_index_start)
        assert np.array_equal(plan.seg_scan_index[at],
                              np.arange(sp.segment_count))


def test_wrapper_checks_its_operands():
    data = torch.zeros(8, dtype=torch.uint8)
    ranges = torch.tensor([[0], [8]], dtype=torch.int32)
    with pytest.raises(ValueError):
        D.destuff_rows(data.int(), ranges, 4)
    with pytest.raises(ValueError):
        D.destuff_rows(data, ranges.long(), 4)
    with pytest.raises(ValueError):
        D.destuff_rows(data, ranges[0], 4)
    with pytest.raises(ValueError):
        D.destuff_rows(data, ranges, 0)
    assert D.destuff_rows(data, ranges, 3).shape == (1, 3)


def _count_d0(monkeypatch) -> list:
    """The segments of each D0 call the pipeline makes from now on (on the
    CPU, where the launch counter counts nothing)."""
    calls, real = [], pipeline.destuff_rows

    def counting(data, ranges, wcap):
        calls.append(ranges.shape[1])
        return real(data, ranges, wcap)
    monkeypatch.setattr(pipeline, "destuff_rows", counting)
    return calls


def _trace_counts(data: bytes) -> list:
    """The counter ``gpujpeg.dec.card_rows`` of each traced call over a
    ``decode`` and a ``decode_to_device`` on the CPU."""
    trace.clear()
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.decode(data)
    dec.decode_to_device(data)
    s = trace.spans()
    names = [trace.NAMES[c] for c in s["name"]]
    counts = [int(b) for n, b in zip(names, s["bytes"])
              if n == "gpujpeg.dec.card_rows"]
    trace.clear()
    return counts


def test_the_counter_is_the_plans_segments_on_the_card_route(monkeypatch):
    """A stream with restart markers: D0 builds every segment's row (the
    counter equals the plan's segments, once a call); one without takes
    the lane route, whose rows the host builds: no counter, no D0."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    img = np.random.default_rng(3).integers(0, 256, (32, 48, 3), np.uint8)
    image = port.ImageParameters(width=48, height=32)
    d0 = _count_d0(monkeypatch)
    for ri in (2, 0):
        data = port.Encoder(backend="golden").encode(
            img.reshape(-1), port.Parameters(quality=80, restart_interval=ri),
            image)
        plan = plan_from_info(read_image(data))[0]
        assert D.lane_eligible(plan) == (ri == 0)
        del d0[:]
        assert _trace_counts(data) == d0 == (
            [plan.n_segments] * 2 if ri else [])


def _host_rows_frame(data: bytes, dec, device) -> torch.Tensor:
    """The frame of ``data`` decoded from the rows built on the host (the
    route before D0) on ``device``."""
    info = read_image(data)
    plan, sd, segs = plan_from_info(info)
    ctx = pipeline.dec_context({}, plan, info, *huffman_maps(info),
                               dec._job(info).out_image, device)
    return ctx.run(torch.from_numpy(ctx.rows(sd, segs)).to(device))


@pytest.mark.parametrize("ri", [1, 4])
def test_decode_frames_equal_the_host_rows_frames(ri, monkeypatch):
    """``decode`` and ``decode_to_device`` (D0 -> D1 -> ...) give the
    frame of the host-built rows, byte for byte, and ``decode_batch``
    too."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    img = np.random.default_rng(ri).integers(0, 256, (24, 40, 3), np.uint8)
    p = port.Parameters(quality=90, restart_interval=ri)
    data = port.Encoder(backend="golden").encode(
        img.reshape(-1), p, port.ImageParameters(width=40, height=24))
    dec = port.Decoder(backend="torch", device="cpu")
    want = _host_rows_frame(data, dec, torch.device("cpu")).numpy()
    d0 = _count_d0(monkeypatch)
    assert np.array_equal(dec.decode(data)[0], want)
    assert np.array_equal(dec.decode_to_device(data)[0].numpy(), want)
    for raw, _ in dec.decode_batch([data, data]):
        assert np.array_equal(raw, want)
    assert len(d0) == 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_card_kernel_equals_gj_build_rows(card, name):
    data, lo, hi = case(name)
    wcap = D._wcap(lo, hi)
    before = D.destuff_rows.launches
    for w in (wcap, 1, 2):
        got = _d0(data, lo, hi, w, card)
        assert torch.equal(got.cpu(), _wanted(data, lo, hi, w, False))
    torch.cuda.synchronize()
    assert D.destuff_rows.launches == before + 3


def _bench_stream(cfg_name: str, **change) -> bytes:
    """The benchmark configuration's first frame (``portbench``'s frames,
    seed 1), encoded by the port on the card; ``change`` overrides keys."""
    import json
    import os

    from portbench.frames import make_pool
    from portbench.program import Program
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           cfg_name + ".json")) as f:
        cfg = {**json.load(f), "pool_frames": 1, **change}
    prog = Program(cfg, {"output": "host"}, torch.device("cuda"), False)
    frame = make_pool(cfg, 1, torch.device("cuda"))[0]
    return prog.encode(frame)


def _card_streams() -> list:
    streams = [("8k", _bench_stream("still_8k_rgb444_q75")),
               ("hd", _bench_stream("video_hd_i420_q75")),
               ("8k_q100_ri64", _bench_stream("still_8k_rgb444_q75",
                                              quality=100,
                                              restart_interval=64))]
    for index in range(40):
        c = soak.case(11, index)
        if c["ri"] == 0:
            continue
        params, image = soak.setup(c)
        good = port.Encoder(backend="golden").encode(
            soak.raw_input(c), params, image)
        for what, bad in soak.corrupt_streams(good, c):
            try:
                read_image(bad)
            except JpegParseError:
                continue
            streams.append((f"soak {index} {what}", bad))
        if len(streams) >= 8:
            break
    return streams


def test_card_rows_and_frames_equal_the_host_builds(card):
    """D0 on the card equals ``gj_build_rows`` on the 8K and HD bench
    streams, a Q100 stream at interval 64 (rows of about 574 words) and
    the soak's corrupt streams; ``decode`` and ``decode_to_device`` of
    each stream that decodes equal the frame of the host-built rows, D0
    launched once a call."""
    for name, data in _card_streams():
        info = read_image(data)
        plan, sd, segs = plan_from_info(info)
        x = D.scan_bytes(plan, sd, segs)
        dev = pipeline.upload_scan(x, card)
        got = D.destuff_rows(dev.data, dev.ranges, dev.wcap).cpu()
        want = torch.from_numpy(D.build_rows(plan, sd, segs))
        assert torch.equal(got, want), name
        if name.startswith("8k_q100"):
            assert want.shape[1] > 500
        dec = port.Decoder(backend="torch", device=card)
        dec.set_output_format(port.ColorSpace.RGB,
                              port.PixelFormat.PF_444_U8_P012)
        if dec._golden_route(plan):
            continue
        frame = _host_rows_frame(data, dec, card).cpu().numpy()
        before = D.destuff_rows.launches
        raw, _ = dec.decode(data)
        on_card, _ = dec.decode_to_device(data)
        torch.cuda.synchronize()
        assert D.destuff_rows.launches == before + 2, name
        assert np.array_equal(raw, frame), name
        assert np.array_equal(on_card.cpu().numpy(), frame), name
