"""Whole streams of the six colour configs of tests/test_quality.py: the
port's general encode (plain torch versions on the CPU) against the JAX
encoder with its Pallas kernels in interpret mode, byte for byte; PIL
opens each stream."""
import io

import numpy as np
import pytest
from PIL import Image

from conftest import make_test_rgb, psnr
from test_torch_encode_general import both, make_raw

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import jax_pipeline as ref_jp

PF, CS = port.PixelFormat, port.ColorSpace
#: the six colour configs of tests/test_quality.py (pixel format, image
#: colour space, sampling, interleaved)
CONFIGS = [
    (PF.PF_444_U8_P012, CS.RGB, 444, False),
    (PF.PF_444_U8_P012A, CS.RGB, 444, False),
    (PF.PF_444_U8_P0P1P2, CS.YCBCR_BT601_256LVLS, 444, False),
    (PF.PF_422_U8_P1020, CS.YCBCR_BT709, 422, False),
    (PF.PF_420_U8_P0P1P2, CS.YCBCR_BT601_256LVLS, 420, True),
    (PF.PF_422_U8_P0P1P2, CS.YCBCR_BT601, 422, True),
]


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (as
    tests/test_pallas_interpret.py does), with fresh executable caches."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    ref_jp._ENC_CACHE.clear()
    yield
    ref_jp._ENC_CACHE.clear()


@pytest.mark.parametrize("q,ri", [(100, 2), (75, 4)])
@pytest.mark.parametrize("pf,cs,sub,interleaved", CONFIGS)
def test_colour_config_stream_matches_jax_interpret(interpret, pf, cs, sub,
                                                    interleaved, q, ri):
    h, w = 96, 160
    raw = make_raw(pf, cs, w, h)
    rparams, rimage = both(ref, pf, cs, w, h, q, ri, sub, interleaved)
    expect = ref.Encoder(backend="jax").encode(raw, rparams, rimage)
    params, image = both(port, pf, cs, w, h, q, ri, sub, interleaved)
    got = port.Encoder(backend="torch", device="cpu").encode(raw, params,
                                                              image)
    assert got == expect
    pil = Image.open(io.BytesIO(got))
    pil.load()
    if pf != PF.PF_444_U8_P012A:    # PIL reads 4 components as CMYK
        assert psnr(np.asarray(pil.convert("RGB")), make_test_rgb(h, w)) > 25
