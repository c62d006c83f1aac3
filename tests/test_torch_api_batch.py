"""The port's batch API against the JAX package's on the CPU:
``Encoder.encode_batch`` equal to the JAX ``encode_batch`` and to the
port's per-frame ``encode`` byte for byte; ``Decoder.decode_batch``
equal to the port's per-frame ``decode`` exactly and to the JAX
``decode_batch`` under ``tests/test_torch_decode.py``'s rule (equal, or
apart only at .5 IDCT ties), with ``CPU_SEGMENT_THRESHOLD`` patched on
both sides so that the device routes run; the bench hook, warm-up and
the memory estimates."""
import numpy as np
import pytest
import torch

from conftest import make_test_rgb
from test_torch_decode import _assert_ties, _port_parts, _d1

import gpujpeg_tpu as ref
import gpujpeg_tpu.models.decoder as ref_dmod
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
from gpujpeg_tpu_torch.ops import pipeline
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.stream.writer import assemble
from gpujpeg_tpu_torch.tables import encode_tables


def _image(mod, h, w, pf="PF_444_U8_P012", cs="RGB"):
    return mod.ImageParameters(width=w, height=h,
                               color_space=getattr(mod.ColorSpace, cs),
                               pixel_format=getattr(mod.PixelFormat, pf))


def _params(mod, q, ri, sub=None, interleaved=False):
    p = mod.Parameters(quality=q, restart_interval=ri,
                       interleaved=interleaved)
    return p if sub is None else p.with_chroma_subsampling(sub)


def _i420(img):
    """An I420 frame (planar 4:2:0 bytes) from an RGB test image."""
    h, w, _ = img.shape
    y = img[:, :, 1]
    u = img[::2, ::2, 0]
    v = img[::2, ::2, 2]
    return np.concatenate([y.ravel(), u.ravel(), v.ravel()])


@pytest.fixture
def threshold(monkeypatch):
    """Set CPU_SEGMENT_THRESHOLD on both sides (0: every stream with
    restart markers takes the device route)."""
    def set_(n):
        monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", n)
        monkeypatch.setattr(ref_dmod, "CPU_SEGMENT_THRESHOLD", n)
    set_(0)
    return set_


# ---------------------------------------------------------------------------
# encode_batch
# ---------------------------------------------------------------------------

ENCODE_CASES = {
    # E1 route: interleaved RGB 4:4:4 at full resolution
    "rgb444": ((64, 80), "PF_444_U8_P012", "RGB", 85, 4, None, False),
    # E0 + E1p route: I420 in, YCbCr 4:2:0 interleaved
    "i420": ((48, 48), "PF_420_U8_P0P1P2", "YCBCR_BT601_256LVLS", 75, 2,
             420, True),
    # the host coder, frame by frame
    "ri0": ((48, 48), "PF_444_U8_P012", "RGB", 75, 0, None, False),
}


def _frames(case):
    (h, w), pf = ENCODE_CASES[case][:2]
    imgs = [make_test_rgb(h, w, seed=s) for s in (1, 2, 3, 4)]
    if pf == "PF_420_U8_P0P1P2":
        return [_i420(i) for i in imgs]
    return [i.reshape(-1) for i in imgs]


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_batch_matches_jax_and_per_frame(case):
    (h, w), pf, cs, q, ri, sub, il = ENCODE_CASES[case]
    frames = _frames(case)
    enc = port.Encoder(device="cpu")
    pp, pi = _params(port, q, ri, sub, il), _image(port, h, w, pf, cs)
    got = enc.encode_batch(frames, pp, pi)
    assert got == [enc.encode(f, pp, pi) for f in frames]
    expect = ref.Encoder(backend="jax").encode_batch(
        frames, _params(ref, q, ri, sub, il), _image(ref, h, w, pf, cs))
    assert got == expect
    assert port.Encoder(backend="golden").encode_batch(frames, pp, pi) == [
        port.Encoder(backend="golden").encode(f, pp, pi) for f in frames]


def test_encode_batch_takes_tensors_and_counts_frames():
    """Tensors are taken as by ``encode``, an empty batch gives [], and
    ``encode_batch_device`` yields one result a frame for any depth."""
    frames = _frames("rgb444")
    pp, pi = _params(port, 85, 4), _image(port, 64, 80)
    enc = port.Encoder(device="cpu")
    want = [enc.encode(f, pp, pi) for f in frames]
    tensors = [torch.from_numpy(f.copy()) for f in frames]
    tensors[1] = tensors[1].view(torch.int32)          # the words form
    assert enc.encode_batch(tensors, pp, pi) == want
    assert enc.encode_batch([], pp, pi) == []
    plan = make_plan(pp, pi)
    quant_zz, huff = encode_tables(pp.quality)
    for depth in (1, 2, 5):
        res = list(pipeline.encode_batch_device(
            enc._contexts, enc.device, frames, plan, quant_zz, huff, depth))
        assert [assemble(plan, quant_zz, huff, *r) for r in res] == want
    with pytest.raises(ValueError, match="depth"):
        list(pipeline.encode_batch_device(enc._contexts, enc.device, frames,
                                          plan, quant_zz, huff, 0))


# ---------------------------------------------------------------------------
# decode_batch
# ---------------------------------------------------------------------------

def _stream(h, w, q, ri, seed=1, interleaved=False):
    img = make_test_rgb(h, w, seed=seed)
    return port.Encoder(backend="golden").encode(
        img.reshape(-1), _params(port, q, ri, interleaved=interleaved),
        _image(port, h, w))


def _decoders():
    dec = port.Decoder(device="cpu")
    dec_ref = ref.Decoder(backend="jax")
    dec.set_output_format(port.ColorSpace.RGB, port.PixelFormat.PF_444_U8_P012)
    dec_ref.set_output_format(ref.ColorSpace.RGB,
                              ref.PixelFormat.PF_444_U8_P012)
    return dec, dec_ref


def _check_batch(datas, window=3):
    dec, dec_ref = _decoders()
    got = dec.decode_batch(datas, window=window)
    assert len(got) == len(datas)
    for (raw, oi), data in zip(got, datas):
        assert isinstance(raw, np.ndarray)
        want, want_oi = dec.decode(data)
        np.testing.assert_array_equal(raw, want)
        assert (oi.width, oi.height) == (want_oi.width, want_oi.height)
    for (raw, oi), (r, roi), data in zip(got, dec_ref.decode_batch(datas),
                                         datas):
        assert (oi.width, oi.height) == (roi.width, roi.height)
        info, plan, ctx, rows = _port_parts(data)
        shape = (oi.height, oi.width, 3)
        _assert_ties(raw.reshape(shape), np.asarray(r).reshape(shape),
                     _d1(ctx, rows), plan, info)
    return got


@pytest.mark.parametrize("window", [3, 1])
def test_decode_batch_matches_jax_and_per_frame(threshold, window):
    """Three frames of one geometry, then one of another (48x48): two
    decode contexts, results in order."""
    datas = [_stream(64, 80, 85, 1, seed=s) for s in (1, 2, 3)]
    datas.append(_stream(48, 48, 85, 1, seed=9))
    _check_batch(datas, window)


def test_decode_batch_mixed_quality_and_golden_route(threshold):
    """Same geometry with another quantisation table in the middle, and a
    frame below the segment threshold (the golden route on both sides)
    between device-route frames."""
    threshold(8)
    datas = [_stream(64, 80, 85, 1, seed=1), _stream(64, 80, 60, 1, seed=2),
             _stream(16, 16, 75, 4, seed=3),           # 3 segments
             _stream(64, 80, 85, 2, seed=4, interleaved=True)]
    dec = port.Decoder(device="cpu")
    assert dec._golden_route(dec._job(port.read_image(datas[2])).plan)
    assert not dec._golden_route(dec._job(port.read_image(datas[3])).plan)
    _check_batch(datas)


def test_decode_batch_to_device_and_planar_output(threshold):
    """``output_to_device`` keeps device-route frames as tensors on the
    decoder's device; another output format goes through D2p + D3."""
    datas = [_stream(64, 80, 85, 1, seed=s) for s in (1, 2)]
    dec = port.Decoder(device="cpu")
    want = [dec.decode(d)[0] for d in datas]
    dec.output_to_device = True
    got = dec.decode_batch(datas)
    dec.output_to_device = False
    for (raw, _), w in zip(got, want):
        assert isinstance(raw, torch.Tensor) and raw.device.type == "cpu"
        np.testing.assert_array_equal(raw.numpy(), w)
    dec.set_output_format(port.ColorSpace.YCBCR_BT709,
                          port.PixelFormat.PF_420_U8_P0P1P2)
    got = dec.decode_batch(datas, window=2)
    for (raw, oi), d in zip(got, datas):
        assert oi.pixel_format == port.PixelFormat.PF_420_U8_P0P1P2
        np.testing.assert_array_equal(raw, dec.decode(d)[0])
    assert dec.decode_batch([]) == []
    with pytest.raises(ValueError, match="window"):
        dec.decode_batch(datas, window=0)


def test_decode_batch_corrupt_frame_raises_and_recovers(threshold):
    data = _stream(64, 80, 85, 4)
    bad = b"\xff\xd8garbage"
    errors = []
    for dec, mod in zip(_decoders(), (port, ref)):
        with pytest.raises(mod.JpegParseError) as e:
            dec.decode_batch([data, bad, data])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    dec, _ = _decoders()
    with pytest.raises(port.JpegParseError):
        dec.decode_batch([data, data, bad, data], window=2)
    raw, oi = dec.decode(data)                 # the decoder still works
    assert raw.size == 64 * 80 * 3
    np.testing.assert_array_equal(dec.decode_batch([data])[0][0], raw)


def test_capture_device_call_replays_the_decode(threshold):
    datas = [_stream(64, 80, 85, 1, seed=s) for s in (1, 2)]
    dec = port.Decoder(device="cpu")
    assert dec.last_device_call is None
    dec.capture_device_call = True
    raw, _ = dec.decode(datas[0])
    fn, args = dec.last_device_call
    assert all(a.device == dec.device for a in args)
    np.testing.assert_array_equal(fn(*args).numpy(), raw)
    got = dec.decode_batch(datas)
    fn, args = dec.last_device_call
    np.testing.assert_array_equal(fn(*args).numpy(), got[-1][0])
    # the golden route records nothing
    dec.last_device_call = None
    threshold(1 << 20)
    dec.decode(datas[0])
    assert dec.last_device_call is None


# ---------------------------------------------------------------------------
# warm-up and memory estimates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "golden"])
def test_warmup_and_allocate(backend):
    pp, pi = _params(port, 75, 4), _image(port, 64, 80)
    frame = make_test_rgb(64, 80).reshape(-1)
    enc = port.Encoder(backend=backend, device="cpu")
    want = enc.encode(frame, pp, pi)
    for fn in ("warmup", "allocate"):
        enc = port.Encoder(backend=backend, device="cpu")
        getattr(enc, fn)(pp, pi)
        assert len(enc._contexts) == (backend == "torch")
        assert enc.encode(frame, pp, pi) == want
        assert len(enc._contexts) == (backend == "torch")
    # the JAX package's warmup takes the same arguments
    ref.Encoder(backend="golden").warmup(_params(ref, 75, 4),
                                        _image(ref, 64, 80))


def test_memory_estimates():
    E = port.Encoder
    for m in (1 << 30, 80 << 30, 12345678901):
        n = E.max_pixels(m)
        assert n > 0
        assert E.max_memory(n) <= m < E.max_memory(n + 1)
    assert E.max_memory(max(E.max_pixels(1 << 30), 0)) <= 1 << 30
    assert E.max_pixels(0) == 0
    # an 8K frame fits the H100's 80 GB many times over; 4 B a pixel of
    # raw frame and a block's 932 B of buffers at 4:4:4 are a floor
    assert E.max_memory(7680 * 4320) < (80 << 30) // 8
    assert E._DEVICE_BYTES_PER_PIXEL >= 4 + 3 * 932 / 64


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (port.Encoder, port.Decoder):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(device="cuda")
    ring = pipeline.PinnedRing(2)
    with pytest.raises(RuntimeError):
        ring.upload(np.zeros(16, np.uint8), torch.device("cuda"))
