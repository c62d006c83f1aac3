"""The port's public API against the JAX package's where the two once
differed: ``Decoder(perf_stats=...)``, the stage statistics
(``EncoderStats``/``DecoderStats`` keys, and the stages that perf stats
fill), and ``decode_to_device`` on the host route, which returns the
host NumPy array."""
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.models.decoder import DecoderStats as RefDecoderStats
from gpujpeg_tpu.models.encoder import EncoderStats as RefEncoderStats
from gpujpeg_tpu_torch.models.decoder import DecoderStats
from gpujpeg_tpu_torch.models.encoder import EncoderStats

STAGES = ("duration_memory_to", "duration_preprocessor",
          "duration_dct_quantization", "duration_huffman_coder",
          "duration_memory_from")


def _params(mod, sub: int, ri: int, **kw):
    p = mod.Parameters(quality=75, restart_interval=ri, **kw)
    return p.with_chroma_subsampling(sub) if sub != 444 else p


def test_decoder_takes_perf_stats_like_the_reference():
    for kw in ({}, {"perf_stats": True}):
        dec = port.Decoder(backend="torch", device="cpu", **kw)
        assert dec.perf_stats == ref.Decoder(backend="jax", **kw).perf_stats
    assert port.Decoder(backend="torch", device="cpu",
                        perf_stats=True).perf_stats is True


@pytest.mark.parametrize("ours,theirs", [(EncoderStats, RefEncoderStats),
                                         (DecoderStats, RefDecoderStats)])
def test_stats_keys_equal_the_reference(ours, theirs):
    assert list(ours().asdict()) == list(theirs().asdict())


@pytest.mark.parametrize("sub", [444, 420])
def test_encode_perf_stats_fill_the_stages(sub):
    """With perf stats the port fills the five stages the reference fills
    (the E1 route's preprocessor is the empty stretch before E1, whose
    colour transform is inside it); without them it leaves the upload
    and copy back at 0, as the reference does."""
    img = make_test_rgb(64, 96)
    image = port.ImageParameters(width=96, height=64)
    enc = port.Encoder(backend="torch", device="cpu")
    enc.encode(img.reshape(-1), _params(port, sub, 1), image)
    st = enc.stats.asdict()
    assert st["duration_memory_to"] == st["duration_memory_from"] == 0.0
    data = enc.encode(img.reshape(-1), _params(port, sub, 1, perf_stats=True),
                      image)
    st = enc.stats.asdict()

    renc = ref.Encoder(backend="jax")
    rimage = ref.ImageParameters(width=96, height=64)
    rdata = renc.encode(img.reshape(-1),
                        _params(ref, sub, 1, perf_stats=True), rimage)
    rst = renc.stats.asdict()
    assert data == rdata
    assert all(rst[k] > 0 for k in STAGES)
    e1_route = sub == 444
    for k in STAGES:
        if e1_route and k == "duration_preprocessor":
            assert 0 <= st[k] < st["duration_dct_quantization"]
        else:
            assert st[k] > 0, k


@pytest.mark.parametrize("sub,pf", [
    (444, port.PixelFormat.PF_444_U8_P012),      # D1 -> D2
    (420, port.PixelFormat.PF_420_U8_P0P1P2)])   # D1 -> D2p -> D3
def test_decode_perf_stats_fill_the_stages(sub, pf):
    img = make_test_rgb(64, 96)
    data = ref.Encoder(backend="golden").encode(
        img.reshape(-1), _params(ref, sub, 1),
        ref.ImageParameters(width=96, height=64))
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.set_output_format(port.ColorSpace.RGB if sub == 444
                          else port.ColorSpace.YCBCR_BT601_256LVLS, pf)
    raw, _ = dec.decode(data)
    st = dec.stats.asdict()
    for k in ("duration_memory_to", "duration_huffman_coder",
              "duration_dct_quantization", "duration_memory_from"):
        assert st[k] > 0, k
    if sub == 444:      # D2 packs the pixels itself
        assert 0 <= st["duration_postprocessor"] \
            < st["duration_dct_quantization"]
    else:
        assert st["duration_postprocessor"] > 0
    plain = port.Decoder(backend="torch", device="cpu")
    plain.set_output_format(dec.output_color_space, pf)
    np.testing.assert_array_equal(plain.decode(data)[0], raw)
    assert plain.stats.duration_huffman_coder == 0.0


@pytest.mark.parametrize("ri", [0, 8])
def test_decode_to_device_on_the_host_route_returns_numpy(ri):
    """Under 32 segments (and without restart markers) both packages
    decode on the host and ``decode_to_device`` returns that array."""
    img = make_test_rgb(16, 24)
    data = ref.Encoder(backend="golden").encode(
        img.reshape(-1), ref.Parameters(quality=75, restart_interval=ri),
        ref.ImageParameters(width=24, height=16))
    got, oi = port.Decoder(backend="torch", device="cpu").decode_to_device(
        data)
    want, roi = ref.Decoder(backend="jax").decode_to_device(data)
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
    assert not isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, port.Decoder(backend="torch", device="cpu").decode(data)[0])
    assert (oi.width, oi.height) == (roi.width, roi.height)
