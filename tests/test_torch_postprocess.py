"""The port's D3 postprocessor (its plain torch version on the CPU)
against the JAX package's ``postprocess``, through NumPy and jax.numpy,
bit for bit: every output pixel format, colour pair, chroma sampling and
component count, at edge sizes, on planes from a NumPy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops.preprocess import postprocess as ref_postprocess
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu_torch.ops import preprocess as pre
from gpujpeg_tpu_torch.plan import make_plan

PF, CS = port.PixelFormat, port.ColorSpace
FORMATS = [pf for pf in PF if pf != PF.NONE]
#: (width, height); UYVY takes the next even width (``postprocess``
#: cannot pack an odd one but 1)
SIZES = [(17, 13), (1, 1), (64, 96)]
#: the stream's plans: (input pixel format, which sets the component
#: count 1/3/4, sampling, interleaved)
STREAM_PLANS = [(PF.U8, 444, False),
                (PF.PF_444_U8_P012, 444, False),
                (PF.PF_444_U8_P012, 422, True),
                (PF.PF_444_U8_P012, 420, True),
                (PF.PF_444_U8_P012A, 444, False),
                (PF.PF_444_U8_P012A, 420, True)]
#: (stream colour space, output colour space): the inverse of every
#: matrix, the forward of every matrix, two pairs composed through RGB,
#: and the identities
PAIRS = [(CS.YCBCR_BT601_256LVLS, CS.RGB), (CS.YCBCR_BT601, CS.RGB),
         (CS.YCBCR_BT709, CS.RGB), (CS.YUV, CS.RGB),
         (CS.RGB, CS.YCBCR_BT601_256LVLS), (CS.RGB, CS.YCBCR_BT601),
         (CS.RGB, CS.YCBCR_BT709), (CS.RGB, CS.YUV),
         (CS.YCBCR_BT601_256LVLS, CS.YCBCR_BT709), (CS.YUV, CS.YCBCR_BT601),
         (CS.YCBCR_BT601_256LVLS, CS.YCBCR_BT601_256LVLS),
         (CS.RGB, CS.RGB), (CS.YCBCR_BT601_256LVLS, CS.NONE)]


def _width(pf, w):
    return w + w % 2 if pf == PF.PF_422_U8_P1020 and w > 1 else w


def _plans(w, h, in_pf, sub, interleaved, cs_int):
    kw = dict(restart_interval=2, interleaved=interleaved)
    plan = make_plan(port.Parameters(color_space_internal=cs_int, **kw)
                     .with_chroma_subsampling(sub),
                     port.ImageParameters(width=w, height=h,
                                          pixel_format=in_pf))
    rplan = ref_make_plan(
        ref.Parameters(color_space_internal=ref.ColorSpace(int(cs_int)),
                       **kw).with_chroma_subsampling(sub),
        ref.ImageParameters(width=w, height=h,
                            pixel_format=ref.PixelFormat(int(in_pf))))
    return plan, rplan


def _compare(pf, w, h, stream, pair, xps, seed):
    """Plain D3 on seeded planes against the JAX package's postprocess;
    where that raises, ``out_geometry`` raises too."""
    in_pf, sub, interleaved = stream
    cs_int, cs_out = pair
    plan, rplan = _plans(w, h, in_pf, sub, interleaved, cs_int)
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, (c.data_height, c.data_width),
                           dtype=np.uint8) for c in plan.components]
    out_image = port.ImageParameters(width=w, height=h, color_space=cs_out,
                                     pixel_format=pf)
    rout = ref.ImageParameters(width=w, height=h,
                               color_space=ref.ColorSpace(int(cs_out)),
                               pixel_format=ref.PixelFormat(int(pf)))
    try:
        want = np.asarray(ref_postprocess(planes, rout, rplan, np))
    except (ValueError, IndexError):
        with pytest.raises(ValueError):
            pre.out_geometry(plan, out_image, "cpu")
        return
    g = pre.out_geometry(plan, out_image, "cpu")
    flat = torch.from_numpy(np.concatenate([p.reshape(-1) for p in planes]))
    got = pre.postprocess_planes(flat, g).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.size == g.raw_bytes == pre.raw_size(out_image)
    for xp in xps:
        np.testing.assert_array_equal(
            got, np.asarray(ref_postprocess([xp.asarray(p) for p in planes],
                                            rout, rplan, xp)))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pf", FORMATS, ids=lambda pf: pf.name)
def test_plain_d3_matches_reference(pf, size):
    """Every stream plan x colour pair through NumPy; each plan once
    through jax.numpy too, on a pair that rotates with the plan."""
    w, h = _width(pf, size[0]), size[1]
    for i, stream in enumerate(STREAM_PLANS):
        for j, pair in enumerate(PAIRS):
            xps = (jnp,) if j == (i * 5 + int(pf)) % len(PAIRS) else ()
            _compare(pf, w, h, stream, pair, xps, seed=i * 100 + j)


def test_odd_width_uyvy_raises_like_reference():
    stream = (PF.PF_444_U8_P012, 422, True)
    _compare(PF.PF_422_U8_P1020, 17, 13, stream, PAIRS[0], (), seed=1)
    plan, _ = _plans(17, 13, *stream, CS.YCBCR_BT601_256LVLS)
    with pytest.raises(ValueError, match="even width"):
        pre.out_geometry(plan, port.ImageParameters(
            width=17, height=13, pixel_format=PF.PF_422_U8_P1020), "cpu")


def test_out_geometry_replicates_by_ceil():
    """Upsampling is by ceil(H / rows), not max_h / h: at 17x13 4:2:0 the
    chroma planes hold 7x9 pixels, replicated by 2 and cropped."""
    plan, _ = _plans(17, 13, PF.PF_444_U8_P012, 420, True,
                     CS.YCBCR_BT601_256LVLS)
    g = pre.out_geometry(plan, port.ImageParameters(width=17, height=13),
                         "cpu")
    assert g.comp.tolist() == [[0, 32, 13, 17, 1, 1],
                               [512, 16, 7, 9, 2, 2],
                               [640, 16, 7, 9, 2, 2]]
    assert g.total == 768 and g.raw_bytes == 17 * 13 * 3
