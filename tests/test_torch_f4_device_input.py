"""``Encoder.encode`` takes a tensor as well as host bytes: a uint8
tensor as it is, an int32 one as its little-endian bytes (the JAX
package's words form). The port's stream from a tensor is held against
the JAX encoder's stream of the same host bytes (its Pallas kernels in
interpret mode) on the main path, a general plan (I420 -> 4:2:0 through
``upload_raw``) and the host route (``restart_interval == 0``);
``decode_to_device``'s output is fed straight back into ``encode`` (the
port's counterpart of ``test_device_words_transcode_chain``); and a
tensor goes through the same checks as host bytes."""
import numpy as np
import pytest
import torch

from test_torch_encode_general import both, make_raw

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as port_dec
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu_torch.ops import pipeline, preprocess as pre
from gpujpeg_tpu_torch.plan import make_plan

PF, CS = port.PixelFormat, port.ColorSpace
#: (pixel format, colour space, sampling, interleaved, restart interval):
#: the main path (E1), I420 -> 4:2:0 interleaved (E0 + E1p), the host route
PLANS = {
    "rgb444": (PF.PF_444_U8_P012, CS.RGB, 444, False, 32),
    "i420": (PF.PF_420_U8_P0P1P2, CS.YCBCR_BT709, 420, True, 4),
    "ri0": (PF.PF_444_U8_P012, CS.RGB, 444, False, 0),
}
H, W = 48, 128


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, with fresh
    executable caches (as tests/test_torch_encode_colour.py runs them)."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    ref_jp._ENC_CACHE.clear()
    yield
    ref_jp._ENC_CACHE.clear()


def _jax_stream(raw: np.ndarray, name: str) -> bytes:
    pf, cs, sub, inter, ri = PLANS[name]
    params, image = both(ref, pf, cs, W, H, 75, ri, sub, inter)
    return ref.Encoder(backend="jax").encode(raw, params, image)


def _port_encode(raw, name: str) -> bytes:
    pf, cs, sub, inter, ri = PLANS[name]
    params, image = both(port, pf, cs, W, H, 75, ri, sub, inter)
    return port.Encoder(backend="torch", device="cpu").encode(
        raw, params, image)


def _words(raw: np.ndarray) -> torch.Tensor:
    """The frame's bytes as int32 words, little-endian (4 | its size)."""
    return torch.from_numpy(raw.copy().view("<i4"))


@pytest.mark.parametrize("form", ["uint8", "shaped", "int32"])
@pytest.mark.parametrize("name", list(PLANS))
def test_tensor_input_matches_jax_stream(interpret, name, form):
    """A flat uint8 tensor, the same bytes shaped as rows, and their int32
    words give the JAX encoder's stream of those bytes, on every route."""
    pf, cs = PLANS[name][:2]
    raw = make_raw(pf, cs, W, H)
    assert raw.size % 4 == 0
    t = {"uint8": lambda: torch.from_numpy(raw.copy()),
         "shaped": lambda: torch.from_numpy(raw.copy()).view(-1, W),
         "int32": lambda: _words(raw)}[form]()
    assert _port_encode(t, name) == _jax_stream(raw, name)


@pytest.mark.parametrize("name", ["rgb444", "i420"])
def test_decode_to_device_feeds_encode(interpret, monkeypatch, name):
    """The chain: ``decode_to_device``'s flat uint8 tensor (the device
    route, ``CPU_SEGMENT_THRESHOLD = 0``), encoded again as it is and as
    its int32 words, gives the JAX encoder's stream of its host bytes."""
    monkeypatch.setattr(port_dec, "CPU_SEGMENT_THRESHOLD", 0)
    pf, cs = PLANS[name][:2]
    data = _port_encode(make_raw(pf, cs, W, H), name)
    dec = port.Decoder(backend="torch", device="cpu")
    dec.set_output_format(cs, pf)
    dev, out_image = dec.decode_to_device(data)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    assert (out_image.width, out_image.height) == (W, H)
    host = dev.numpy().copy()
    want = _jax_stream(host, name)
    assert _port_encode(dev, name) == want
    assert _port_encode(dev.view(torch.int32), name) == want


def test_tensor_on_the_device_is_not_copied():
    """A uint8 tensor on the encoder's device reaches the kernels as it
    is, and int32 words as a view of their bytes."""
    raw = make_raw(*PLANS["i420"][:2], W, H)
    image = port.ImageParameters(
        width=W, height=H, color_space=CS.YCBCR_BT709,
        pixel_format=PF.PF_420_U8_P0P1P2)
    cpu = torch.device("cpu")
    t = torch.from_numpy(raw.copy())
    up = pre.upload_raw(t.view(-1, W), image, cpu)
    assert up.data_ptr() == t.data_ptr() and up.shape == t.shape
    words = _words(raw)
    up = pre.upload_raw(words, image, cpu)
    assert up.data_ptr() == words.data_ptr()
    assert np.array_equal(up.numpy(), raw)
    rgb = torch.from_numpy(make_raw(PF.PF_444_U8_P012, CS.RGB, W, H))
    params, img = both(port, PF.PF_444_U8_P012, CS.RGB, W, H, 75, 32, 444,
                       False)
    up = pipeline.upload_rgb(rgb, make_plan(params, img), cpu)
    assert up.data_ptr() == rgb.data_ptr() and up.shape == (H, W, 3)


@pytest.mark.parametrize("name", list(PLANS))
def test_tensor_of_wrong_size_or_dtype_raises(name):
    """A tensor one byte short, one word short, or of another dtype raises
    ValueError on every route (the byte count checked as ``upload_raw``
    checks host bytes), as host bytes one byte short do."""
    pf, cs = PLANS[name][:2]
    raw = make_raw(pf, cs, W, H)
    with pytest.raises(ValueError):
        _port_encode(raw[:-1], name)
    with pytest.raises(ValueError, match="bytes"):
        _port_encode(torch.from_numpy(raw[:-1].copy()), name)
    with pytest.raises(ValueError, match="bytes"):
        _port_encode(_words(raw)[:-1], name)
    with pytest.raises(ValueError, match="uint8 or int32"):
        _port_encode(torch.from_numpy(raw.copy()).to(torch.int16), name)


def test_uyvy_tensor_of_odd_width_raises():
    image = port.ImageParameters(width=5, height=4,
                                 color_space=CS.YCBCR_BT709,
                                 pixel_format=PF.PF_422_U8_P1020)
    raw = torch.zeros(pre.raw_size(image), dtype=torch.uint8)
    with pytest.raises(ValueError, match="even width"):
        pre.upload_raw(raw, image, "cpu")
    params = port.Parameters(quality=75, restart_interval=0)
    with pytest.raises(ValueError, match="even width"):
        port.Encoder(backend="golden").encode(raw, params, image)
