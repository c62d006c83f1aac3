"""The port's E0 preprocessor (its plain torch version on the CPU)
against the JAX package's ``preprocess``, through jax.numpy and NumPy:
every pixel format, colour pair and chroma sampling, at edge sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops.preprocess import preprocess as ref_preprocess
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu_torch.ops import colorspace, preprocess as pre
from gpujpeg_tpu_torch.plan import make_plan

PF, CS = port.PixelFormat, port.ColorSpace
FORMATS = [pf for pf in PF if pf != PF.NONE]
#: (width, height); UYVY takes the next even width (the reference's
#: loader cannot unpack an odd one)
SIZES = [(17, 13), (1, 1), (64, 96)]
#: the 6 colour configs of tests/test_quality.py, then a pair of two
#: non-RGB spaces (composed through RGB) and the RGB identity:
#: (pixel format, image colour space, JPEG colour space, sampling,
#: interleaved)
COLOUR_CONFIGS = [
    (PF.PF_444_U8_P012, CS.RGB, CS.YCBCR_BT601_256LVLS, 444, False),
    (PF.PF_444_U8_P012A, CS.RGB, CS.YCBCR_BT601_256LVLS, 444, False),
    (PF.PF_444_U8_P0P1P2, CS.YCBCR_BT601_256LVLS, CS.YCBCR_BT601_256LVLS,
     444, False),
    (PF.PF_422_U8_P1020, CS.YCBCR_BT709, CS.YCBCR_BT601_256LVLS, 422, False),
    (PF.PF_420_U8_P0P1P2, CS.YCBCR_BT601_256LVLS, CS.YCBCR_BT601_256LVLS,
     420, True),
    (PF.PF_422_U8_P0P1P2, CS.YCBCR_BT601, CS.YCBCR_BT601_256LVLS, 422, True),
    (PF.PF_444_U8_P012, CS.YUV, CS.YCBCR_BT601, 444, False),
    (PF.PF_444_U8_P012, CS.RGB, CS.RGB, 444, False),
]


def _width(pf, w):
    return w + w % 2 if pf == PF.PF_422_U8_P1020 else w


def _compare(pf, w, h, cs, cs_int, sub, interleaved, seed=0):
    """Plain E0 on random bytes against the JAX package's preprocess."""
    image = port.ImageParameters(width=w, height=h, color_space=cs,
                                 pixel_format=pf)
    params = port.Parameters(restart_interval=2, interleaved=interleaved,
                             color_space_internal=cs_int
                             ).with_chroma_subsampling(sub)
    plan = make_plan(params, image)
    raw = np.random.default_rng(seed).integers(
        0, 256, pre.raw_size(image), dtype=np.uint8)
    g = pre.plane_geometry(plan, "cpu")
    got = pre.preprocess_planes(pre.upload_raw(raw, image, "cpu"), g).numpy()

    rimage = ref.ImageParameters(width=w, height=h,
                                 color_space=ref.ColorSpace(int(cs)),
                                 pixel_format=ref.PixelFormat(int(pf)))
    rparams = ref.Parameters(restart_interval=2, interleaved=interleaved,
                             color_space_internal=ref.ColorSpace(int(cs_int))
                             ).with_chroma_subsampling(sub)
    rplan = ref_make_plan(rparams, rimage)
    for xp, a in ((np, raw), (jnp, jnp.asarray(raw))):
        planes = ref_preprocess(a, rimage, rplan, xp)
        want = np.concatenate([np.asarray(p).reshape(-1) for p in planes])
        np.testing.assert_array_equal(got, want)
    assert got.size == g.total == sum(c.data_width * c.data_height
                                      for c in plan.components)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pf", FORMATS)
def test_plain_e0_matches_reference_every_format(pf, size):
    cs = CS.RGB if pf == PF.PF_444_U8_P012A else CS.YCBCR_BT709
    for sub in (444, 422, 420):
        _compare(pf, _width(pf, size[0]), size[1], cs,
                 CS.YCBCR_BT601_256LVLS, sub, sub != 444)


@pytest.mark.parametrize("sub", [444, 422, 420])
@pytest.mark.parametrize("pf,cs,cs_int,_sub,interleaved", COLOUR_CONFIGS)
def test_plain_e0_matches_reference_colour_configs(pf, cs, cs_int, _sub,
                                                   interleaved, sub):
    _compare(pf, _width(pf, 17), 13, cs, cs_int, sub, interleaved, seed=sub)


def test_pair_consts_cover_every_pair():
    """The E0 constants of every colour pair, applied by the plain form,
    equal the host ``transform`` on every byte triple of a sweep."""
    rng = np.random.default_rng(5)
    chans = [rng.integers(0, 256, 4096).astype(np.int32) for _ in range(3)]
    chans[0][:3] = (0, 255, 128)
    spaces = [cs for cs in CS]
    for a in spaces:
        for b in spaces:
            want = colorspace.transform(chans, a, b, np)
            consts = colorspace.pair_consts(a, b, 3)
            got = colorspace.apply_pair(
                [torch.from_numpy(c) for c in chans], consts)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), w)
    assert colorspace.pair_consts(CS.RGB, CS.YUV, 1) == (0,) * 26


def test_upload_raw_checks_the_byte_count():
    image = port.ImageParameters(width=6, height=5,
                                 pixel_format=PF.PF_420_U8_P0P1P2)
    n = 30 + 2 * 3 * 3
    assert pre.raw_size(image) == n
    assert pre.upload_raw(bytes(n), image, "cpu").shape == (n,)
    with pytest.raises(ValueError, match="needs"):
        pre.upload_raw(bytes(n - 1), image, "cpu")
    uyvy = port.ImageParameters(width=5, height=2,
                                pixel_format=PF.PF_422_U8_P1020)
    with pytest.raises(ValueError, match="even width"):
        pre.upload_raw(bytes(20), uyvy, "cpu")


def test_e0_wrapper_checks_operands():
    image = port.ImageParameters(width=16, height=8,
                                 pixel_format=PF.PF_422_U8_P1020)
    plan = make_plan(port.Parameters(restart_interval=1)
                     .with_chroma_subsampling(422), image)
    g = pre.plane_geometry(plan, "cpu")
    raw = pre.upload_raw(bytes(16 * 8 * 2), image, "cpu")
    assert pre.preprocess_planes(raw, g).shape == (g.total,)
    with pytest.raises(ValueError, match="device"):
        pre.preprocess_planes(raw.to("meta"), g)
    with pytest.raises(ValueError):
        pre.preprocess_planes(raw[1:], g)
    with pytest.raises(ValueError):
        pre.preprocess_planes(raw.to(torch.int32), g)
