"""Streams without restart markers on the port's device route: the lane
decoder D1L (``ops/decode.py`` ``huffman_lanes``, its plain form on the
CPU) against ``plain_restartless.py``'s sequential T.81 decode, coefficient
for coefficient, on 4:2:0 and 4:2:2 interleaved, 4:2:2, 4:2:0 and 4:4:4
non-interleaved (three scans) and grayscale streams, odd sizes among them,
from the port's golden encoder at interval 0 and from libjpeg (PIL, with
the Annex K tables and with optimised ones), at lane widths small enough
for many lanes a scan; a stream built to synchronise late, at the bound on
the rounds; ``Decoder.decode``'s pixels against the golden route under the
soak's IDCT rule; the routing rule by blocks and ``decode_batch`` on the
route; truncated and bit-flipped scans, where the lanes equal D1 on the
same rows or the parse raises ``JpegParseError``.

The card cases (the ``card`` fixture: they skip without a card) hold the
kernel to its plain form, rounds included, and the public entry points to
the lane kernel by its launch counter. The file needs nothing of
``conftest.py``, which imports JAX, so on a card's machine, which has no
JAX and no PIL: ``python -m pytest --noconftest
tests/test_torch_restartless.py -q``."""
import io

import numpy as np
import pytest
import torch

import plain_restartless as plain

import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
from gpujpeg_tpu_torch.models.decoder import (Decoder, huffman_maps,
                                               plan_from_info)
from gpujpeg_tpu_torch.ops import decode as D
from gpujpeg_tpu_torch.ops import pipeline
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.stream.reader import JpegParseError, read_image
from gpujpeg_tpu_torch.tools import checks

#: (height, width, chroma subsampling, interleaved, quality) of the port's
#: golden encoder's streams at interval 0
PORT = {"420i": (37, 53, 420, True, 85), "420i_odd": (61, 77, 420, True, 92),
        "422i": (40, 46, 422, True, 75), "422n": (40, 48, 422, False, 85),
        "444n": (33, 29, 444, False, 100), "420n": (31, 45, 420, False, 50)}
#: PIL's subsampling argument of each libjpeg layout (interleaved scans)
PIL_LAYOUTS = {"444": 0, "422": 1, "420": 2}
#: lane widths: 33 bits cuts codes and value bits anywhere
LANE_BITS = (33, 96)


@pytest.fixture
def card():
    """The CUDA card, decided when a test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rgb(h: int, w: int, seed: int, noise: float = 6.0) -> np.ndarray:
    """(h, w, 3) uint8 of smooth fields and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0),
                    128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0),
                    128 + 70 * np.sin((x + y) / 41.0)], axis=-1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0,
                   255).astype(np.uint8)


def port_stream(name: str, seed: int = 1, img=None) -> bytes:
    h, w, sub, il, q = PORT[name]
    p = port.Parameters(quality=q, restart_interval=0, interleaved=il)
    if sub != 444:
        p = p.with_chroma_subsampling(sub)
    img = rgb(h, w, seed) if img is None else img
    return port.Encoder(backend="golden").encode(
        img.reshape(-1), p, port.ImageParameters(width=w, height=h))


def pil_stream(layout: str, optimize: bool, seed: int = 2) -> bytes:
    Image = pytest.importorskip("PIL.Image")
    img = rgb(45, 61, seed)
    buf = io.BytesIO()
    if layout == "gray":
        Image.fromarray(img[:, :, 0]).save(buf, "JPEG", quality=90,
                                          optimize=optimize)
    else:
        Image.fromarray(img).save(buf, "JPEG", quality=90, optimize=optimize,
                                  subsampling=PIL_LAYOUTS[layout])
    return buf.getvalue()


def parts(data: bytes, device="cpu"):
    """(decode context, rows on ``device``, each segment's data bits) of
    a stream decoded to interleaved RGB."""
    info = read_image(data)
    plan, sd, segs = plan_from_info(info)
    dc, ac = huffman_maps(info)
    out = port.ImageParameters(width=info.width, height=info.height)
    ctx = pipeline.dec_context({}, plan, info, dc, ac, out,
                                torch.device(device))
    rows = torch.from_numpy(ctx.rows(sd, segs)).to(device)
    return ctx, rows, (D._geometry_fields(ctx.geo)["bits"] if ctx.lanes
                       else None)


def lanes(ctx, rows, bits, lane_bits):
    """(coefficients, rounds, the lane geometry) of D1L on the rows."""
    t = ctx.tables
    geo = D.lane_geometry(ctx.lane_segs, bits, lane_bits)
    out, rounds = D.huffman_lanes(rows, geo, ctx.n_blocks, t.wide, t.maxcode,
                                  t.delta, t.huffval, t.dc_slot, t.ac_slot)
    return out, int(rounds[0]), geo


def d1(ctx, rows):
    t = ctx.tables
    return D.huffman_decode(rows, ctx.seg_start, ctx.seg_count,
                            ctx.block_comp, t.wide, t.maxcode, t.delta,
                            t.huffval, t.dc_slot, t.ac_slot)


def check_against_plain(data: bytes, lane_bits: int):
    ctx, rows, bits = parts(data)
    assert ctx.lanes and rows.shape[0] == len(read_image(data).scans)
    got, rounds, geo = lanes(ctx, rows, bits, lane_bits)
    assert torch.equal(got, plain.decode(data))
    f = D._geometry_fields(geo)
    assert 1 <= rounds <= f["max_lanes"]
    return f, rounds


# ---------------------------------------------------------------------------
# the lanes against the sequential reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_bits", LANE_BITS)
@pytest.mark.parametrize("name", sorted(PORT))
def test_port_streams_equal_the_sequential_reference(name, lane_bits):
    f, _ = check_against_plain(port_stream(name), lane_bits)
    assert f["n_seg"] == (1 if PORT[name][3] else 3)
    assert f["n_lanes"] >= 2 * f["n_seg"]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("layout", ["420", "422", "444", "gray"])
def test_libjpeg_streams_equal_the_sequential_reference(layout, optimize):
    """libjpeg's streams: the Annex K tables, and with ``optimize`` tables
    of the image's own statistics."""
    data = pil_stream(layout, optimize)
    assert read_image(data).restart_interval == 0
    f, _ = check_against_plain(data, 40)
    assert f["n_lanes"] > 10


def test_late_synchronisation_stays_within_the_bound():
    """A flat frame: every MCU codes the same bits, so a lane started at a
    guess never meets the true symbol boundaries, and each round settles
    one more lane; the rounds reach the bound's order and the coefficients
    are still exact."""
    data = port_stream("420i", img=np.full((37, 53, 3), 77, np.uint8))
    f, rounds = check_against_plain(data, 8)
    assert f["max_lanes"] >= 8
    assert f["max_lanes"] // 2 <= rounds <= f["max_lanes"]


def test_one_lane_a_segment_is_d1():
    """Lanes wider than the scan: one lane a segment, one round, D1's
    decode."""
    data = port_stream("422n")
    ctx, rows, bits = parts(data)
    got, rounds, geo = lanes(ctx, rows, bits, 1 << 20)
    assert int(geo[1]) == 3 and rounds == 1
    assert torch.equal(got, d1(ctx, rows))


def test_another_frames_geometry_gives_the_same_coefficients():
    """The context decodes by the lane geometry of the rows it built
    last; another frame's of the plan (more lanes or fewer than the data
    needs) gives the same coefficients, in other rounds."""
    ctx, rows, bits = parts(port_stream("420n", seed=1))
    want = ctx.coefficients(rows)
    assert torch.equal(want, plain.decode(port_stream("420n", seed=1)))
    for seed, noise in ((2, 0.0), (3, 30.0)):
        other = port_stream("420n", img=rgb(31, 45, seed, noise))
        plan, sd, segs = plan_from_info(
            read_image(other))
        ctx.rows(sd, segs)
        assert not np.array_equal(D._geometry_fields(ctx.geo)["bits"], bits)
        assert torch.equal(ctx.coefficients(rows), want)


def test_the_row_builder_counts_each_segments_words(monkeypatch):
    """``build_rows``' word counts, natively and by the NumPy fallback:
    each segment's destuffed bytes over 4, rounded up; the rows the
    same either way. A lane decode before any rows raises."""
    for name in ("444n", "420i"):
        plan, sd, segs = plan_from_info(
            read_image(port_stream(name)))
        got = []
        for native in (True, False):
            if not native:
                monkeypatch.setattr("gpujpeg_tpu_torch.native.lib",
                                    lambda: None)
            words = np.full(plan.n_segments, -1, np.int64)
            got.append((D.build_rows(plan, sd, segs, words), words))
            monkeypatch.undo()
        (rows, words), (rows_np, words_np) = got
        np.testing.assert_array_equal(rows, rows_np)
        np.testing.assert_array_equal(words, words_np)
        concat, lo, hi, _ = D.segment_ranges_wcap(sd, segs, plan)
        for s in range(plan.n_segments):
            d = concat[lo[s]:hi[s]]
            n = d.size - int(((d[1:] == 0) & (d[:-1] == 0xFF)).sum())
            assert words[s] == -(-n // 4)
            assert not rows[s, words[s]:].any() and rows[s, words[s] - 1]
    info = read_image(port_stream("420i"))
    ctx = pipeline.dec_context({}, plan, info, *huffman_maps(info),
                                port.ImageParameters(width=53, height=37),
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="DecContext.rows"):
        ctx.coefficients(torch.from_numpy(rows))


def test_lane_geometry_checks():
    ctx, _, _ = parts(port_stream("420n"))
    geo = D.lane_geometry(ctx.lane_segs, [1000, 0, 64], 64)
    f = D._geometry_fields(geo)
    assert f["lane0"].tolist() == [0, 16, 17, 18]
    assert f["max_lanes"] == 16 and f["n_lanes"] == 18
    assert f["bpm"].tolist() == [1, 1, 1]
    with pytest.raises(ValueError, match="2\\*\\*30"):
        D.lane_geometry(ctx.lane_segs, [1 << 31, 0, 0], 64)
    with pytest.raises(ValueError, match="rows"):
        D.huffman_lanes(torch.zeros((2, 4), dtype=torch.int32), geo,
                        ctx.n_blocks, *(getattr(ctx.tables, k) for k in (
                            "wide", "maxcode", "delta", "huffval",
                            "dc_slot", "ac_slot")))


# ---------------------------------------------------------------------------
# the public entry points
# ---------------------------------------------------------------------------

def _decoders():
    dev, gold = (Decoder(backend=b, device="cpu") for b in ("torch",
                                                            "golden"))
    for d in (dev, gold):
        d.set_output_format(port.ColorSpace.RGB,
                            port.PixelFormat.PF_444_U8_P012)
    return dev, gold


@pytest.mark.parametrize("name", ["420i_odd", "422n", "444n"])
def test_decode_pixels_against_the_golden_route(name, monkeypatch):
    """``Decoder.decode`` through D1L, D2p and D3 against the golden
    route on the same stream: coefficients exact, bytes within the
    soak's IDCT rule."""
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    data = port_stream(name)
    calls = []
    real = pipeline.huffman_lanes
    monkeypatch.setattr(pipeline, "huffman_lanes",
                        lambda *a: calls.append(1) or real(*a))
    dev, gold = _decoders()
    got, oi = dev.decode(data)
    want, _ = gold.decode(data)
    assert calls == [1]
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= checks.PIXEL_STEP
    ctx, rows, _ = parts(data)
    coeff = ctx.coefficients(rows)
    assert torch.equal(coeff, plain.decode(data))
    assert checks.decode_pair(data, oi, got, "cpu") <= checks.PIXEL_STEP


def test_the_route_is_decided_by_the_frames_blocks(monkeypatch):
    """A frame without restart markers of fewer blocks than
    ``CPU_BLOCK_THRESHOLD`` takes the golden route, one of as many the
    device route; with restart markers the rule by segments holds at any
    block threshold; the 12 MP camera frame takes the device route."""
    data = port_stream("420i")
    n = plan_from_info(
        read_image(data))[0].n_blocks
    routes = []
    monkeypatch.setattr(pipeline, "decode_device",
                        lambda *a, **k: routes.append("device") or (
                            _ for _ in ()).throw(RuntimeError("stop")))
    real = Decoder._decode_golden
    monkeypatch.setattr(Decoder, "_decode_golden",
                        lambda self, *a: routes.append("golden")
                        or real(self, *a))
    dec = Decoder(backend="torch", device="cpu")
    for threshold, route in ((n + 1, "golden"), (n, "device"),
                             (0, "device")):
        monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", threshold)
        try:
            dec.decode(data)
        except RuntimeError:
            pass
        assert routes.pop() == route
    marked = port.Encoder(backend="golden").encode(
        rgb(64, 80, 5).reshape(-1),
        port.Parameters(quality=85, restart_interval=8),
        port.ImageParameters(width=80, height=64))
    plan = plan_from_info(read_image(marked))[0]
    assert plan.n_segments < dmod.CPU_SEGMENT_THRESHOLD <= plan.n_blocks
    assert dec._golden_route(plan)
    photo = make_plan(port.Parameters(quality=92, restart_interval=0,
                                      interleaved=True)
                      .with_chroma_subsampling(420),
                      port.ImageParameters(width=4032, height=3024))
    monkeypatch.undo()
    assert photo.n_blocks == 285_768 and photo.n_segments == 1
    assert not Decoder(backend="torch", device="cpu")._golden_route(photo)
    assert D.lane_eligible(photo)


def test_decode_batch_takes_the_lane_route(monkeypatch):
    """``decode_batch`` of streams without restart markers launches the
    lanes once a frame and equals ``decode`` frame by frame."""
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    datas = [port_stream("420i", seed=s) for s in (1, 2)]
    datas.append(port_stream("444n"))
    calls = []
    real = pipeline.huffman_lanes
    monkeypatch.setattr(pipeline, "huffman_lanes",
                        lambda *a: calls.append(1) or real(*a))
    dec, _ = _decoders()
    got = dec.decode_batch(datas, window=2)
    assert len(calls) == 3
    for (raw, _), data in zip(got, datas):
        np.testing.assert_array_equal(raw, dec.decode(data)[0])


def _damaged(data: bytes) -> list:
    """(what, stream) of a truncated scan, single bits flipped, a run of
    ones (invalid codes) and a cut before EOI."""
    sos = data.rfind(b"\xff\xda")
    body = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    out = [("truncated", data[:(body + len(data)) // 2] + b"\xff\xd9")]
    rng = np.random.default_rng(5)
    for i in range(2):
        at = int(rng.integers(body, len(data) - 2))
        if data[at] == 0xFF or data[at - 1] == 0xFF:
            continue
        flip = bytearray(data)
        flip[at] ^= 1 << int(rng.integers(0, 8))
        if flip[at] == 0xFF:
            continue
        out.append((f"flip {i}", bytes(flip)))
    mid = (body + len(data)) // 2
    out.append(("ones", data[:mid] + b"\xff\x00" * 8 + data[mid + 8:]))
    out.append(("cut", data[:-10] + b"\xff\xd9"))
    return out


@pytest.mark.parametrize("name", ["420i", "422n"])
def test_corrupt_scans_equal_d1_or_fail_to_parse(name, monkeypatch):
    """Each damaged stream either fails to parse (JpegParseError) or
    decodes: the lanes' coefficients equal D1's on the same rows, and
    ``Decoder.decode`` returns a frame of the stream's size."""
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    dec, _ = _decoders()
    decoded = 0
    for what, bad in _damaged(port_stream(name)):
        try:
            ctx, rows, bits = parts(bad)
        except JpegParseError:
            with pytest.raises(JpegParseError):
                dec.decode(bad)
            continue
        want = d1(ctx, rows)
        for lane_bits in (96, D.LANE_BITS):
            got, rounds, geo = lanes(ctx, rows, bits, lane_bits)
            assert torch.equal(got, want), (what, lane_bits)
        raw, oi = dec.decode(bad)
        assert raw.size == oi.width * oi.height * 3
        decoded += 1
    assert decoded >= 3


def test_d1_routes_are_unchanged_with_restart_markers(monkeypatch):
    """Interval 1 or more: D1, no lanes."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    calls = []
    monkeypatch.setattr(pipeline, "huffman_lanes",
                        lambda *a: calls.append(1))
    img = rgb(40, 48, 3)
    data = port.Encoder(backend="golden").encode(
        img.reshape(-1), port.Parameters(quality=75, restart_interval=2),
        port.ImageParameters(width=48, height=40))
    dec, gold = _decoders()
    ctx, rows, _ = parts(data)
    assert not ctx.lanes
    got, _ = dec.decode(data)
    assert calls == [] and got.shape == gold.decode(data)[0].shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_bits", (33, 97, 512))
@pytest.mark.parametrize("name", sorted(PORT))
def test_card_kernel_equals_its_plain_form(card, name, lane_bits):
    data = port_stream(name)
    ctx, rows, bits = parts(data)
    want, want_rounds, _ = lanes(ctx, rows, bits, lane_bits)
    ctx_c, rows_c, _ = parts(data, card)
    before = D.huffman_lanes.launches
    got, rounds, geo = lanes(ctx_c, rows_c, bits, lane_bits)
    assert D.huffman_lanes.launches == before + 1
    assert torch.equal(got.cpu(), want) and rounds == want_rounds


def test_card_flat_frame_and_corrupt_scans(card):
    """The late-synchronising flat frame and the damaged streams: the
    kernel equals its plain form."""
    streams = [port_stream("420i", img=np.full((37, 53, 3), 77, np.uint8))]
    streams += [bad for _, bad in _damaged(port_stream("420i_odd"))]
    for data in streams:
        try:
            ctx, rows, bits = parts(data)
        except JpegParseError:
            continue
        for lane_bits in (8, 64):
            want, want_rounds, _ = lanes(ctx, rows, bits, lane_bits)
            ctx_c, rows_c, _ = parts(data, card)
            got, rounds, _ = lanes(ctx_c, rows_c, bits, lane_bits)
            assert torch.equal(got.cpu(), want) and rounds == want_rounds


def test_card_entry_points_take_the_lanes(card, monkeypatch):
    """``decode``, ``decode_to_device`` and ``decode_batch`` of a frame
    without restart markers above the threshold launch the lane kernel
    once a call and D1 never, and never take the golden route; the frame
    equals the CPU route's under the IDCT rule."""
    h, w = 384, 512
    img = rgb(h, w, 4)
    p = port.Parameters(quality=92, restart_interval=0) \
        .with_chroma_subsampling(420)
    data = port.Encoder(backend="golden").encode(
        img.reshape(-1), p, port.ImageParameters(width=w, height=h))
    monkeypatch.setattr(Decoder, "_decode_golden", lambda *a: (
        _ for _ in ()).throw(AssertionError("golden route")))
    dec = Decoder(backend="torch", device=card)
    dec.set_output_format(port.ColorSpace.RGB, port.PixelFormat.PF_444_U8_P012)
    assert not dec._golden_route(plan_from_info(
        read_image(data))[0])
    d1_before, before = D.huffman_decode.launches, D.huffman_lanes.launches
    raw, oi = dec.decode(data)
    on_card, _ = dec.decode_to_device(data)
    batch = dec.decode_batch([data, data])
    torch.cuda.synchronize()
    assert D.huffman_lanes.launches == before + 4
    assert D.huffman_decode.launches == d1_before
    assert on_card.device.type == "cuda"
    np.testing.assert_array_equal(on_card.cpu().numpy(), raw)
    for r, _ in batch:
        np.testing.assert_array_equal(r, raw)
    monkeypatch.undo()
    assert checks.decode_pair(data, oi, raw, card) <= checks.PIXEL_STEP
