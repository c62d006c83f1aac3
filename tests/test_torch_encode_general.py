"""The port's general encode (E0 -> E1p -> E2 -> E3, plain torch versions
on the CPU) against the JAX package: E1p's coefficients against the
staged XLA DCT, and a sweep of plans that the torch backend must all
encode. The six colour configs' whole streams are in
tests/test_torch_encode_colour.py."""
import itertools

import numpy as np
import pytest
import torch

from conftest import make_test_rgb, psnr

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu.ops.colorspace import transform as ref_transform
from gpujpeg_tpu.ops.preprocess import pack_raw as ref_pack_raw
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu_torch.ops import dct
from gpujpeg_tpu_torch.ops.pipeline import EncContext
from gpujpeg_tpu_torch.ops.preprocess import upload_raw
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.tables import encode_tables

PF, CS = port.PixelFormat, port.ColorSpace
CPU = torch.device("cpu")
#: a float32 quotient may round the other way than the reference's only
#: where the float64 quotient lies this close to .5
TIE_EPS = 1e-4


def make_raw(pf, cs, w, h, seed=7):
    """A test frame in pixel format ``pf`` and colour space ``cs``: the
    RGB fixture transformed and packed by the JAX package's host code
    (alpha 255 for P012A, the first channel for U8)."""
    rgb = make_test_rgb(h, w, seed)
    chans = ref_transform([rgb[:, :, c].astype(np.int32) for c in range(3)],
                          ref.ColorSpace.RGB, ref.ColorSpace(int(cs)), np)
    if pf == PF.PF_444_U8_P012A:
        chans = chans + [np.full((h, w), 255, np.int32)]
    if pf == PF.U8:
        chans = chans[:1]
    image = ref.ImageParameters(width=w, height=h,
                                color_space=ref.ColorSpace(int(cs)),
                                pixel_format=ref.PixelFormat(int(pf)))
    return ref_pack_raw(chans, image, np)


def both(mod, pf, cs, w, h, q, ri, sub, interleaved, cs_int=None):
    """(params, image) of one plan in the port (``mod=port``) or the JAX
    package (``mod=ref``)."""
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace(int(cs)),
                                pixel_format=mod.PixelFormat(int(pf)))
    kw = {} if cs_int is None else {
        "color_space_internal": mod.ColorSpace(int(cs_int))}
    params = mod.Parameters(quality=q, restart_interval=ri,
                            interleaved=interleaved,
                            **kw).with_chroma_subsampling(sub)
    return params, image


@pytest.mark.parametrize("pf,cs,cs_int,w,h,q,ri,sub,interleaved", [
    (PF.PF_420_U8_P0P1P2, CS.YCBCR_BT601_256LVLS, None, 72, 40, 75, 2, 420,
     True),
    (PF.PF_422_U8_P1020, CS.YCBCR_BT709, None, 66, 34, 90, 3, 422, False),
    (PF.U8, CS.YCBCR_BT601_256LVLS, None, 33, 17, 50, 5, 444, False),
    (PF.PF_444_U8_P012A, CS.RGB, None, 40, 24, 98, 4, 444, False),
    (PF.PF_444_U8_P012, CS.RGB, None, 17, 13, 75, 1, 420, True),
    (PF.PF_444_U8_P012Z, CS.YUV, CS.YCBCR_BT601, 48, 32, 20, 2, 422, True),
])
def test_plain_e1p_matches_staged_xla_dct(pf, cs, cs_int, w, h, q, ri, sub,
                                          interleaved):
    import jax.numpy as jnp
    from gpujpeg_tpu.ops.blocks import plane_to_blocks
    from gpujpeg_tpu.ops.preprocess import preprocess
    from gpujpeg_tpu.tables import fdct_quant_matrix

    raw = make_raw(pf, cs, w, h)
    params, image = both(port, pf, cs, w, h, q, ri, sub, interleaved, cs_int)
    plan = make_plan(params, image)
    ctx = EncContext(plan, *encode_tables(params.quality),
                      CPU)
    coeff = ctx.coefficients_planes(upload_raw(raw, image, CPU)).numpy()

    rparams, rimage = both(ref, pf, cs, w, h, q, ri, sub, interleaved,
                           cs_int)
    rplan = ref_make_plan(rparams, rimage)
    enc = ref.Encoder(backend="jax")
    rctx = ref_jp._enc_context(rplan, *enc._tables(rparams))
    s_pre, s_dct, _ = rctx._stage_fns
    rows = np.asarray(s_dct(s_pre(jnp.asarray(raw)), *rctx._stage_args[0]))
    real = rctx.geo.coeff_idx < rplan.n_blocks
    expect = np.zeros_like(coeff)
    expect[rctx.geo.coeff_idx[real]] = rows[real]

    diff = coeff != expect
    assert np.abs(coeff.astype(np.int64) - expect).max(initial=0) <= 1
    if diff.any():
        quant_zz = enc._tables(rparams)[0]
        planes = preprocess(raw, rimage, rplan, np)
        y = np.concatenate([
            plane_to_blocks(planes[c.index], np).astype(np.float64)
            @ fdct_quant_matrix(quant_zz[c.quant_table_index])[0]
            - fdct_quant_matrix(quant_zz[c.quant_table_index])[1]
            for c in rplan.components])[rplan.block_plane_idx]
        assert np.abs(y[diff] - np.floor(y[diff]) - 0.5).max() < TIE_EPS


SWEEP = list(itertools.product(
    [pf for pf in PF if pf != PF.NONE], [444, 422, 420], [False, True]))


@pytest.mark.parametrize("pf,sub,interleaved", SWEEP)
def test_torch_backend_encodes_every_plan(pf, sub, interleaved):
    """No plan with restart markers raises on the torch backend; each
    stream decodes (golden decoder) to what the golden encoder's stream
    decodes to, up to .5 DCT ties."""
    w = 18 if pf == PF.PF_422_U8_P1020 else 17
    h = 13
    cs = {PF.U8: CS.YCBCR_BT601_256LVLS, PF.PF_444_U8_P012A: CS.RGB,
          PF.PF_422_U8_P1020: CS.YCBCR_BT709}.get(pf, CS.YUV)
    raw = make_raw(pf, cs, w, h, seed=3)
    for q, ri in ((30, 1), (95, 3)):
        params, image = both(port, pf, cs, w, h, q, ri, sub, interleaved)
        got = port.Encoder(backend="torch", device="cpu").encode(
            raw, params, image)
        gold = port.Encoder(backend="golden").encode(raw, params, image)
        dec = port.Decoder(backend="golden")
        dec.set_output_format(CS.RGB, PF.PF_444_U8_P012)
        a, _ = dec.decode(got)
        b, _ = dec.decode(gold)
        assert a.shape == b.shape
        assert psnr(a, b) > 40


def test_e1p_wrapper_checks_operands():
    params, image = both(port, PF.PF_420_U8_P0P1P2, CS.YCBCR_BT601_256LVLS,
                         16, 16, 75, 1, 420, True)
    plan = make_plan(params, image)
    ctx = EncContext(plan, *encode_tables(params.quality),
                      CPU)
    t, g = ctx.tables, ctx.planes
    planes = torch.zeros(g.total, dtype=torch.uint8)
    args = (planes, t.dct, t.bias, ctx.qdiv, g.blk, g.block_plane_idx)
    assert dct.fdct_quant_planes(*args).shape == (plan.n_blocks, 64)
    with pytest.raises(ValueError, match="device"):
        dct.fdct_quant_planes(*(a.to("meta") for a in args))
    with pytest.raises(ValueError):
        dct.fdct_quant_planes(planes[64:], *args[1:])
    with pytest.raises(ValueError):
        dct.fdct_quant_planes(*args[:3], ctx.qdiv[:2], *args[4:])
