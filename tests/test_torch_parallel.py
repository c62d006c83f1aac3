"""The port's band- and frame-sharded encode and decode
(``gpujpeg_tpu_torch.parallel``) against the JAX package on the CPU: the
pure helpers against ``gpujpeg_tpu.parallel``'s, sharded streams byte
for byte against the JAX ``ShardedEncoder`` (on the 8-device CPU mesh of
``tests/conftest.py``), the JAX ``Encoder(backend="jax")`` and the port's
``Encoder``, and sharded decodes bit for bit against the port's
``Decoder`` and under ``tests/test_torch_decode.py``'s tie rule against
the JAX ``ShardedDecoder``. The port's meshes repeat ``cpu``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from conftest import make_test_rgb
from test_torch_decode import _assert_ties, _d1, _port_parts

import gpujpeg_tpu as ref
import gpujpeg_tpu.parallel as ref_par
import gpujpeg_tpu.parallel.sharded as ref_sh
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
import gpujpeg_tpu_torch.parallel as par
import gpujpeg_tpu_torch.parallel.sharded as sh
from gpujpeg_tpu_torch.ops import pipeline


def _jax_mesh(frame: int, seg: int) -> JaxMesh:
    devs = np.array(jax.devices()[:frame * seg]).reshape(frame, seg)
    return JaxMesh(devs, ("frame", "seg"))


def _mesh(frame: int, seg: int) -> par.Mesh:
    return par.Mesh([["cpu"] * seg for _ in range(frame)])


def _setup(mod, h, w, q=80, ri=4, interleaved=False, sub=None,
           pf="PF_444_U8_P012", cs="RGB"):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=getattr(mod.ColorSpace, cs),
                                pixel_format=getattr(mod.PixelFormat, pf))
    params = mod.Parameters(quality=q, restart_interval=ri,
                            interleaved=interleaved)
    if sub is not None:
        params = params.with_chroma_subsampling(sub)
    return params, image


def _both(h, w, **kw):
    return _setup(port, h, w, **kw), _setup(ref, h, w, **kw)


def _i420(img):
    """An I420 frame (planar 4:2:0 bytes) from an RGB test image."""
    return np.concatenate([img[:, :, 1].ravel(), img[::2, ::2, 0].ravel(),
                           img[::2, ::2, 2].ravel()])


def _layout_key(layout):
    return (layout.n_bands, layout.rows_per_band, layout.band_raw_bytes,
            layout.plan.n_segments,
            tuple(s.segment_count for s in layout.plan.scans),
            layout.band_image.height)


def _same_layouts(pp, pi, rp, ri_, n):
    """The port's and the JAX package's plan_bands over ``n`` bands: both
    raise ValueError (then None), or both give the same band plans and
    global markers (then the two layouts)."""
    try:
        ref_layout = ref_sh.plan_bands(rp, ri_, n)
    except ValueError:
        with pytest.raises(ValueError):
            sh.plan_bands(pp, pi, n)
        return None
    layout = sh.plan_bands(pp, pi, n)
    assert _layout_key(layout) == _layout_key(ref_layout)
    for a, b in zip(sh._global_rst_arrays(layout),
                    ref_sh._global_rst_arrays(ref_layout)):
        np.testing.assert_array_equal(a, b)
    return layout, ref_layout


# ---------------------------------------------------------------------------
# the pure helpers
# ---------------------------------------------------------------------------

SAMPLINGS = [(sub, inter) for sub in (444, 420, 422) for inter in (False,
                                                                    True)]


@pytest.mark.parametrize("sub,interleaved", SAMPLINGS)
def test_restart_interval_and_plans_match_reference(sub, interleaved):
    """1920x1088 over 8 and 4 bands: the chosen interval, the band plans'
    segment counts and the global markers equal the JAX package's, and
    plan_bands raises where the JAX package's does (136-row bands of
    4:2:0)."""
    (pp, pi), (rp, ri_) = _both(1088, 1920, ri=0, sub=sub,
                                interleaved=interleaved)
    for n in (8, 4):
        ri = sh.choose_restart_interval(pp, pi, n)
        assert ri == ref_sh.choose_restart_interval(rp, ri_, n) >= 1
        _same_layouts(dataclasses.replace(pp, restart_interval=ri), pi,
                      dataclasses.replace(rp, restart_interval=ri), ri_, n)


PIXEL_FORMATS = [pf.name for pf in port.PixelFormat
                 if pf != port.PixelFormat.NONE]


@pytest.mark.parametrize("pf", PIXEL_FORMATS)
def test_split_and_stitch_match_reference(pf):
    """Every pixel format at 128x160 over 8 bands: split_raw_bands of
    bytes, of a uint8 tensor and of its int32 words equals the JAX
    package's; _stitch of the bands equals the JAX ShardedDecoder's and
    gives the frame back."""
    (pp, pi), (rp, ri_) = _both(128, 160, ri=2, pf=pf)
    layout, ref_layout = _same_layouts(pp, pi, rp, ri_, 8)
    size = port.types.image_calculate_size(160, 128, pi.pixel_format)
    raw = np.random.default_rng(3).integers(0, 256, size, dtype=np.uint8)
    want = ref_sh.split_raw_bands(raw, ri_, ref_layout)
    np.testing.assert_array_equal(sh.split_raw_bands(raw, pi, layout), want)
    np.testing.assert_array_equal(
        sh.split_raw_bands(raw.tobytes(), pi, layout), want)
    t = torch.from_numpy(raw)
    np.testing.assert_array_equal(
        sh.split_raw_bands(t, pi, layout).numpy(), want)
    if size % 4 == 0:
        np.testing.assert_array_equal(
            sh.split_raw_bands(t.view(torch.int32), pi, layout).numpy(),
            want)
    stitched = sh._stitch(want, pi, layout)
    np.testing.assert_array_equal(
        stitched, ref_sh.ShardedDecoder._stitch(want, ri_, ref_layout))
    np.testing.assert_array_equal(stitched, raw)


def test_plan_bands_rejects_where_reference_does():
    cases = [(100, 64, dict(ri=2)),            # rows not whole MCU rows
             (128, 64, dict(ri=0)),            # no restart markers
             (128, 160, dict(ri=3)),           # 3 does not divide 40 MCUs
             (120, 64, dict(ri=2)),            # 8 does not divide 120 rows
             (128, 160, dict(ri=2, sub=420))]  # 16 rows, MCU 16: fine
    got = [_same_layouts(*sum(_both(h, w, **kw), ()), 8) is None
           for h, w, kw in cases]
    assert got == [True, True, True, True, False]


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (par.ShardedEncoder, par.ShardedDecoder):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
    with pytest.raises(ValueError):
        par.Mesh([])
    m = _mesh(2, 3)
    assert m.axis_names == ("frame", "seg")
    assert m.shape == {"frame": 2, "seg": 3}
    assert m.devices[1, 2] == torch.device("cpu")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interleaved", [False, True])
def test_sharded_encode_equals_every_reference(interleaved):
    """128x160 Q80 interval 4 over 8 bands: 10 segments a band in each
    scan, not a multiple of 8, so every band's markers are the frame's."""
    img = make_test_rgb(128, 160, seed=3)
    (pp, pi), (rp, ri_) = _both(128, 160, interleaved=interleaved)
    enc = par.ShardedEncoder(_mesh(1, 8))
    got = enc.encode(img, pp, pi)
    layout = next(iter(enc._cache.values())).layout
    assert all(s.segment_count == 10 for s in layout.plan.scans)
    assert got == ref_par.ShardedEncoder(_jax_mesh(1, 8)).encode(img, rp, ri_)
    assert got == ref.Encoder(backend="jax").encode(img, rp, ri_)
    assert got == port.Encoder(device="cpu").encode(img, pp, pi)
    fn, args = enc.last_device_call
    for (ctx, *_), (out, out_len, _, _) in zip(args[0], fn(*args)):
        assert out.shape[0] == out_len.shape[0] == layout.plan.n_segments


def test_sharded_encode_i420_and_tensor_input():
    """I420 in, 4:2:0 interleaved, over 4 bands at the interval
    choose_restart_interval gives (2: 10 segments a band); over 8 bands
    16 rows hold 10 MCUs, which interval 4 does not divide."""
    raw = _i420(make_test_rgb(128, 160, seed=4))
    kw = dict(ri=0, sub=420, interleaved=True, pf="PF_420_U8_P0P1P2",
              cs="YCBCR_BT709")
    (pp, pi), (rp, ri_) = _both(128, 160, **kw)
    ri = sh.choose_restart_interval(pp, pi, 4)
    assert ri == ref_sh.choose_restart_interval(rp, ri_, 4) == 2
    pp, rp = (dataclasses.replace(p, restart_interval=ri) for p in (pp, rp))
    got = par.ShardedEncoder(_mesh(1, 4)).encode(raw, pp, pi)
    assert got == ref_par.ShardedEncoder(_jax_mesh(1, 4)).encode(raw, rp, ri_)
    assert got == ref.Encoder(backend="jax").encode(raw, rp, ri_)
    assert got == port.Encoder(device="cpu").encode(raw, pp, pi)
    enc = par.ShardedEncoder(_mesh(1, 4))
    assert enc.encode(torch.from_numpy(raw), pp, pi) == got
    with pytest.raises(ValueError):
        sh.plan_bands(dataclasses.replace(pp, restart_interval=4), pi, 8)


def test_sharded_encode_batch_over_frames_and_bands():
    frames = [make_test_rgb(64, 64, seed=s) for s in range(3)]
    pp, pi = _setup(port, 64, 64, q=75, ri=2)
    got = par.ShardedEncoder(_mesh(2, 4)).encode_batch(frames, pp, pi)
    enc = port.Encoder(device="cpu")
    assert got == [enc.encode(f, pp, pi) for f in frames]


def test_sharded_encode_noisy_frame():
    """The JAX package's tier-2 frame (noise, Q90): nothing to rerun in
    the port (E2 and E3 are sized for the worst case), same stream."""
    noisy = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    (pp, pi), (rp, ri_) = _both(64, 64, q=90, ri=2)
    got = par.ShardedEncoder(_mesh(1, 8)).encode(noisy, pp, pi)
    assert got == ref.Encoder(backend="jax").encode(noisy, rp, ri_)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.fixture
def device_route(monkeypatch):
    """The port's Decoder takes the device route at any segment count."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)


def test_sharded_decode_round_trip(device_route):
    img = make_test_rgb(128, 160, seed=5)
    (pp, pi), (rp, ri_) = _both(128, 160, q=85)
    data = port.Encoder(device="cpu").encode(img, pp, pi)
    raw, oi = par.ShardedDecoder(_mesh(1, 8)).decode(data)
    assert (oi.width, oi.height) == (160, 128)
    want, _ = port.Decoder(device="cpu").decode(data)
    np.testing.assert_array_equal(raw, want)
    ref_raw, _ = ref_par.ShardedDecoder(_jax_mesh(1, 8)).decode(data)
    info, plan, ctx, rows = _port_parts(data)
    _assert_ties(raw.reshape(128, 160, 3), ref_raw.reshape(128, 160, 3),
                 _d1(ctx, rows), plan, info)


def test_sharded_decode_i420_planar_output(device_route):
    raw_in = _i420(make_test_rgb(128, 160, seed=6))
    pp, pi = _setup(port, 128, 160, ri=2, sub=420, interleaved=True,
                    pf="PF_420_U8_P0P1P2", cs="YCBCR_BT709")
    data = port.Encoder(device="cpu").encode(raw_in, pp, pi)
    raw, oi = par.ShardedDecoder(_mesh(1, 4)).decode(data)
    assert oi.pixel_format == port.PixelFormat.PF_420_U8_P0P1P2
    np.testing.assert_array_equal(raw,
                                  port.Decoder(device="cpu").decode(data)[0])


def test_sharded_decode_routes_non_aligned_stream(monkeypatch):
    # 40 rows do not split into 8 bands of whole MCU rows
    img = make_test_rgb(40, 64, seed=6)
    pp, pi = _setup(port, 40, 64, ri=3)
    data = port.Encoder(backend="golden").encode(img, pp, pi)
    dec = par.ShardedDecoder(_mesh(1, 8))

    def no_bands(*a, **k):
        raise AssertionError("the bands ran")

    monkeypatch.setattr(dec, "_launch", no_bands)
    raw, _ = dec.decode(data)
    np.testing.assert_array_equal(raw,
                                  port.Decoder(device="cpu").decode(data)[0])


def _streams():
    pp, pi = _setup(port, 64, 96, q=85, ri=2)
    enc = port.Encoder(backend="golden")
    streams = [enc.encode(make_test_rgb(64, 96, seed=s), pp, pi)
               for s in (1, 2)]
    # 40 rows do not divide into 4 whole-MCU-row bands
    p3, i3 = _setup(port, 40, 48, q=85, ri=2)
    streams.append(enc.encode(make_test_rgb(40, 48, seed=3), p3, i3))
    return streams


@pytest.mark.parametrize("window", [1, 3])
def test_sharded_decode_batch_matches_per_frame(window):
    """A batch with a stream routed to the single-device Decoder in it."""
    streams = _streams()
    dec = par.ShardedDecoder(_mesh(1, 4))
    want = [dec.decode(s) for s in streams]
    got = dec.decode_batch(streams, window=window)
    assert len(got) == len(want) == 3
    for (g, gi), (w, wi) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(g, w)


def test_sharded_decode_reuses_context():
    """Same-geometry frames reuse one decode context per geometry and
    device (the counterpart of the reference's one cached executable)."""
    streams = _streams()[:2]
    dec = par.ShardedDecoder(_mesh(1, 4))
    r1, _ = dec.decode(streams[0])
    assert len(dec._contexts) == 1
    r2, _ = dec.decode(streams[1])
    assert len(dec._contexts) == 1
    assert r1.size == r2.size


def test_band_failure_raises_from_decode_and_batch(monkeypatch):
    """A kernel that fails in one band raises from decode and from
    decode_batch (no re-decode hides it); a decode after it succeeds."""
    streams = _streams()[:2]
    dec = par.ShardedDecoder(_mesh(1, 4))
    want, _ = dec.decode(streams[1])
    real = pipeline.huffman_decode
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) % 4 == 3:
            raise RuntimeError("gj_huffman_decode: CUDA launch failed")
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "huffman_decode", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        dec.decode(streams[0])
    calls.clear()
    with pytest.raises(RuntimeError, match="launch failed"):
        dec.decode_batch(streams)
    monkeypatch.setattr(pipeline, "huffman_decode", real)
    np.testing.assert_array_equal(dec.decode(streams[1])[0], want)
