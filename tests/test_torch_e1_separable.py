"""E1's separable float32 evaluation order — the ``fdct_quant`` kernel's:
a row pass and a column pass of 8 terms with the 8x8 factor on the raw
pixels, the zig-zag gather, the bias subtracted last — rendered in
float32 torch, against the JAX package's float64 golden DCT and the
port's plain E1 (the dense float32 operator), at Q1, Q50, Q75 and Q100.

The bound is ``chip_smoke.py``'s: a float32 evaluation lies within
``F32_DOT_REL * (x @ |D| + |bias|)`` of the float64 value, two of them
within twice that of each other, so their quotients may round apart only
where the float64 quotient lies within twice the bound (over the
divisor) of .5.

E1p (``fdct_quant_planes``) runs E1's order over the scan-order blocks of
any plan: the same rendering on ``dct.scan_order_blocks`` of E0's planes
is held to the plain E1p and to the JAX package's staged XLA DCT on
4:2:0 interleaved (I420 in), 4:2:2, grayscale and 4:4:4 RGB plans, and on
4:4:4 RGB to the rendering of E1 bit for bit."""
import numpy as np
import pytest
import torch

from gpujpeg_tpu.tables import ZIGZAG_TO_NATURAL as REF_ZIGZAG
from gpujpeg_tpu.tables import dct8_matrix as ref_dct8_matrix
from gpujpeg_tpu.tables import dct_zigzag_operator as ref_dct_zigzag_operator
from gpujpeg_tpu.tables import quant_table_zz as ref_quant_table_zz
from gpujpeg_tpu_torch.ops import dct
from gpujpeg_tpu_torch.tables import dct8_matrix
from gpujpeg_tpu_torch.types import ComponentType, ColorSpace, PixelFormat

F32_DOT_REL = 2.0 ** -17
QUALITIES = (1, 50, 75, 100)


def _blocks() -> np.ndarray:
    """(N, 64) uint8 raster blocks: seeded noise, smooth ramps, all 0,
    all 255 and checkerboards."""
    rng = np.random.default_rng(17)
    noise = rng.integers(0, 256, (256, 64))
    y, x = np.mgrid[0:8, 0:8]
    ramps = np.stack([np.clip(a * x + b * y + c, 0, 255).reshape(64)
                      for a, b, c in rng.integers(-40, 40, (64, 3))
                      + np.array([0, 0, 128])])
    board = ((x + y) % 2 * 255).reshape(64)
    special = np.stack([np.zeros(64), np.full(64, 255), board, 255 - board])
    return np.concatenate([noise, ramps, special]).astype(np.uint8)


def separable_f32(blocks: torch.Tensor, d8: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The kernel's order in float32: row pass ``t[r][u] = sum_k x[r][k]
    d8[u][k]``, column pass ``y[v][u] = sum_r d8[v][r] t[r][u]`` (each in
    index order), zig-zag gather, then ``- bias``."""
    x = blocks.to(torch.float32).view(-1, 8, 8)
    t = torch.zeros_like(x)
    for k in range(8):
        t = t + x[:, :, k:k + 1] * d8[:, k][None, None, :]
    y = torch.zeros_like(x)
    for r in range(8):
        y = y + d8[:, r][None, :, None] * t[:, r:r + 1, :]
    zz = torch.as_tensor(REF_ZIGZAG, dtype=torch.int64)
    return y.reshape(-1, 64)[:, zz] - bias


def test_dct8_is_the_factor_of_the_zigzag_operator():
    D64, _ = ref_dct_zigzag_operator()
    D8 = ref_dct8_matrix()
    np.testing.assert_array_equal(np.kron(D8, D8)[REF_ZIGZAG, :].T, D64)
    np.testing.assert_array_equal(dct8_matrix(), D8)


@pytest.mark.parametrize("q", QUALITIES)
def test_separable_order_within_the_f32_bound(q):
    blocks = torch.from_numpy(_blocks())
    D64, bias64 = ref_dct_zigzag_operator()
    x64 = blocks.numpy().astype(np.float64)
    y64 = x64 @ D64 - bias64
    eps = F32_DOT_REL * (x64 @ np.abs(D64) + np.abs(bias64))

    d8 = torch.as_tensor(ref_dct8_matrix().astype(np.float32))
    dense = torch.as_tensor(D64.astype(np.float32))
    bias = torch.as_tensor(bias64.astype(np.float32))
    y_sep = separable_f32(blocks, d8, bias).double().numpy()
    y_plain = dct.fdct_blocks_plain(blocks, dense, bias).double().numpy()
    assert (np.abs(y_sep - y64) <= eps).all()
    assert (np.abs(y_sep - y_plain) <= 2 * eps).all()

    # quantised: the separable order's quotients against the plain E1's,
    # both per luma and chroma divisor row
    for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE):
        qz = np.maximum(ref_quant_table_zz(ct, q), 1).astype(np.float32)
        qt = torch.as_tensor(qz)
        c_sep = torch.round(torch.as_tensor(y_sep, dtype=torch.float32)
                            / qt).to(torch.int64).numpy()
        c_plain = dct.quantize_plain(torch.as_tensor(
            y_plain, dtype=torch.float32), qt).numpy()
        d = np.abs(c_sep - c_plain)
        assert d.max(initial=0) <= 1
        yq = y64 / qz
        far = np.abs(np.abs(yq - np.floor(yq)) - 0.5)
        assert (far[d != 0] <= 2 * eps[d != 0] / qz[np.nonzero(d)[1]]).all()
        # and against the golden coefficients: within one bound of .5
        gold = np.rint(yq)
        dg = c_sep != gold
        assert (far[dg] <= eps[dg] / qz[np.nonzero(dg)[1]]).all()


def test_kernel_factor_is_dct8_in_float32():
    """``csrc/dct8.cuh``, which E1 (``fdct_quant.cu``) and D2
    (``idct_rgb.cu``) include, compiles in the 8x8 factor (``kD8``); its
    64 literals are ``tables.dct8_matrix()`` rounded to float32, the JAX
    package's factor."""
    import os
    import re
    from gpujpeg_tpu_torch import _build
    for name in ("fdct_quant.cu", "idct_rgb.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            assert '#include "dct8.cuh"' in f.read()
    with open(os.path.join(_build.CSRC, "dct8.cuh")) as f:
        src = f.read()
    body = re.search(r"__constant__ float kD8\[64\] = \{([^}]*)\};", src)
    assert body is not None
    lits = re.findall(r"(-?[0-9.]+(?:e-?[0-9]+)?)f", body.group(1))
    kd8 = np.array([np.float32(v) for v in lits], np.float32)
    assert kd8.shape == (64,)
    np.testing.assert_array_equal(
        kd8.reshape(8, 8), ref_dct8_matrix().astype(np.float32))


def test_fdct_quant_on_the_cpu_is_plain_and_checks_operands():
    """On the CPU the wrapper runs the plain version; a wrong operand or
    a device other than the CPU's and CUDA's raises."""
    import gpujpeg_tpu_torch as port
    from gpujpeg_tpu_torch.ops.pipeline import EncContext, upload_rgb
    from gpujpeg_tpu_torch.tables import encode_tables
    from gpujpeg_tpu_torch.plan import make_plan
    params = port.Parameters(quality=75, restart_interval=2)
    image = port.ImageParameters(width=16, height=16)
    plan = make_plan(params, image)
    ctx = EncContext(plan, *encode_tables(params.quality),
                     torch.device("cpu"))
    t = ctx.tables
    rgb = upload_rgb(np.random.default_rng(1).integers(
        0, 256, (16, 16, 3), dtype=np.uint8), plan, torch.device("cpu"))
    e1 = (rgb, t.dct, t.bias, ctx.qdiv, ctx.xf, False)
    assert torch.equal(dct.fdct_quant(*e1), dct.fdct_quant_plain(*e1))
    with pytest.raises(ValueError, match="bias"):
        dct.fdct_quant(rgb, t.dct, t.bias.double(), ctx.qdiv, ctx.xf, False)
    with pytest.raises(ValueError, match="device"):
        dct.fdct_quant(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                         for a in e1))


# ---------------------------------------------------------------------------
# E1p: the same order over the scan-order blocks of any plan
# ---------------------------------------------------------------------------

#: name -> (input pixel format, colour space, sampling, interleaved)
PLANS = {
    "420i-i420": (PixelFormat.PF_420_U8_P0P1P2, ColorSpace.YCBCR_BT709, 420,
                  True),
    "422": (PixelFormat.PF_422_U8_P0P1P2, ColorSpace.YCBCR_BT601, 422,
            False),
    "gray": (PixelFormat.U8, ColorSpace.YCBCR_BT601_256LVLS, 444, False),
    "444-rgb": (PixelFormat.PF_444_U8_P012, ColorSpace.RGB, 444, False),
}
SIZES = ((17, 13), (200, 136))


def _plan_parts(name, w, h, interleaved=None, q=75, ri=1):
    """(raw frame, encode context on the CPU, E0's plain planes) of one
    PLANS entry at ``w`` x ``h``."""
    from test_torch_encode_general import both, make_raw
    import gpujpeg_tpu_torch as port
    from gpujpeg_tpu_torch.ops.pipeline import EncContext
    from gpujpeg_tpu_torch.tables import encode_tables
    from gpujpeg_tpu_torch.ops.preprocess import (
        preprocess_planes_plain, upload_raw)
    from gpujpeg_tpu_torch.plan import make_plan
    pf, cs, sub, inter = PLANS[name]
    inter = inter if interleaved is None else interleaved
    raw = make_raw(pf, cs, w, h, seed=w + h)
    params, image = both(port, pf, cs, w, h, q, ri, sub, inter)
    ctx = EncContext(make_plan(params, image),
                     *encode_tables(params.quality), torch.device("cpu"))
    planes = preprocess_planes_plain(upload_raw(raw, image, "cpu"),
                                     ctx.planes)
    return raw, ctx, planes


def _render_e1p(ctx, planes):
    """The kernel's order on the scan-order blocks of ``planes``: (NB, 64)
    int32 quotients and the (NB, 64) uint8 blocks, (NB, 64) divisors."""
    g = ctx.planes
    blocks, comp = dct.scan_order_blocks(planes, g.blk, g.block_plane_idx)
    y = separable_f32(blocks, torch.as_tensor(
        ref_dct8_matrix().astype(np.float32)), ctx.tables.bias)
    qdiv = ctx.qdiv[comp]
    return torch.round(y / qdiv).to(torch.int32), blocks, qdiv


def _assert_quotient_ties(a, b, blocks, qdiv):
    """Two float32 evaluations' quotients may differ only by 1, and only
    where the float64 quotient lies within twice the bound of .5."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1
    D64, bias64 = ref_dct_zigzag_operator()
    x = np.asarray(blocks, np.float64)
    q = np.asarray(qdiv, np.float64)
    yq = (x @ D64 - bias64) / q
    eps = F32_DOT_REL * (x @ np.abs(D64) + np.abs(bias64)) / q
    far = np.abs(np.abs(yq - np.floor(yq)) - 0.5)
    assert (far[d != 0] <= 2 * eps[d != 0]).all()


def _jax_coefficients(name, w, h, raw, interleaved, q=75, ri=1):
    """The JAX package's staged XLA preprocess + DCT of the same plan, in
    the port's scan order (as tests/test_torch_encode_general.py runs
    it). Restart interval 1 gives its staged rows no padding rows, which
    its packed form cannot take."""
    import jax.numpy as jnp
    import gpujpeg_tpu as ref
    from test_torch_encode_general import both
    from gpujpeg_tpu.ops import jax_pipeline as ref_jp
    from gpujpeg_tpu.plan import make_plan as ref_make_plan
    pf, cs, sub, _ = PLANS[name]
    rparams, rimage = both(ref, pf, cs, w, h, q, ri, sub, interleaved)
    rplan = ref_make_plan(rparams, rimage)
    enc = ref.Encoder(backend="jax")
    rctx = ref_jp._enc_context(rplan, *enc._tables(rparams))
    s_pre, s_dct, _ = rctx._stage_fns
    rows = np.asarray(s_dct(s_pre(jnp.asarray(raw)), *rctx._stage_args[0]))
    real = rctx.geo.coeff_idx < rplan.n_blocks
    expect = np.zeros((rplan.n_blocks, 64), np.int64)
    expect[rctx.geo.coeff_idx[real]] = rows[real]
    return expect


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("name", list(PLANS))
def test_e1p_order_on_scan_order_blocks(name, w, h):
    """E1p's order over the plan's scan-order blocks against the plain
    E1p (the dense float32 operator) and against the JAX package's
    coefficients, by the float32 tie rule."""
    raw, ctx, planes = _plan_parts(name, w, h)
    got, blocks, qdiv = _render_e1p(ctx, planes)
    assert got.shape == (ctx.plan.n_blocks, 64)
    g = ctx.planes
    plain = dct.fdct_quant_planes_plain(planes, ctx.tables.dct,
                                        ctx.tables.bias, ctx.qdiv, g.blk,
                                        g.block_plane_idx)
    _assert_quotient_ties(got, plain, blocks, qdiv)
    _assert_quotient_ties(got, _jax_coefficients(
        name, w, h, raw, ctx.interleaved), blocks, qdiv)


@pytest.mark.parametrize("interleaved", (False, True))
def test_e1p_order_on_e0_planes_equals_e1(interleaved):
    """On 4:4:4 RGB, E1p's order on E0's planes is E1's order on E1's
    own colour transform and blocks, bit for bit: the kernels share the
    passes and the arithmetic, so they must agree."""
    from gpujpeg_tpu_torch.ops.rgbpack import rgb_to_planes
    w, h = SIZES[1]
    raw, ctx, planes = _plan_parts("444-rgb", w, h, interleaved)
    assert ctx.rgb_route
    vals = ctx.xf.tolist()
    rgb = torch.from_numpy(raw.reshape(h, w, 3))
    p3 = rgb_to_planes(rgb, (None, None) if vals[12]
                       else (vals[:9], vals[9:12]))
    blocks = (p3.reshape(3, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
              .reshape(3, -1, 64))
    comp = torch.arange(3)[:, None].expand(3, blocks.shape[1])
    if interleaved:
        blocks, comp = blocks.permute(1, 0, 2), comp.T
    blocks, comp = blocks.reshape(-1, 64), comp.reshape(-1)
    y = separable_f32(blocks, torch.as_tensor(
        ref_dct8_matrix().astype(np.float32)), ctx.tables.bias)
    e1 = torch.round(y / ctx.qdiv[comp]).to(torch.int32)
    e1p, scan_blocks, _ = _render_e1p(ctx, planes)
    assert torch.equal(scan_blocks, blocks)
    assert torch.equal(e1p, e1)
