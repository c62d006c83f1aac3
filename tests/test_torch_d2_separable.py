"""D2's separable float32 evaluation order — the ``idct_rgb`` kernel's:
dequantise by the zig-zag table, a column pass and a row pass with the
8x8 factor, each 8-point sum split into its even and odd terms (fused
multiply-adds), then + 128 — rendered in
float32 on the host, against the JAX package's float64 IDCT operator
(``idct_dequant_matrix``) and the port's plain D2 (the dense float32
operator ``wq``), at Q1, Q50, Q75 and Q100 on photo-like, noise and
extreme blocks.

The bound is ``chip_smoke.py``'s: a float32 evaluation lies within
``eps = F32_DOT_REL * (|x| @ |W| + 128)`` of the float64 value, two of
them within twice that of each other, so their pixels may round apart
only where the float64 value lies within twice the bound of .5.

D2p (``idct_planes``) runs D2's order over the scan-order blocks of any
plan: the same rendering, written to the planes, is held to the plain
D2p and to the JAX package's plan tail (``dequant_idct_device`` +
``blocks_to_plane``) on 4:2:0 interleaved, 4:2:2, grayscale and 4:4:4
RGB streams, and with the plain D3 on 4:4:4 RGB to the rendering of D2
bit for bit."""
import numpy as np
import pytest
import torch

from gpujpeg_tpu.tables import ZIGZAG_TO_NATURAL as REF_ZIGZAG
from gpujpeg_tpu.tables import dct8_matrix as ref_dct8_matrix
from gpujpeg_tpu.tables import fdct_quant_matrix as ref_fdct_quant_matrix
from gpujpeg_tpu.tables import idct_dequant_matrix as ref_idct_dequant
from gpujpeg_tpu.tables import quant_table_zz as ref_quant_table_zz
from gpujpeg_tpu_torch.ops import dct
from gpujpeg_tpu_torch.ops.rgbpack import transform_consts_tensor
from gpujpeg_tpu_torch.types import ComponentType

F32_DOT_REL = 2.0 ** -17
QUALITIES = (1, 50, 75, 100)


def _fma32(a, b, c):
    """float32 fmaf: the exact product plus c, rounded once (a float64 sum
    of a 48-bit product and a float32 can round twice only at a tie of
    its own, far below the bound)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _pass(x: np.ndarray, d8: np.ndarray) -> np.ndarray:
    """One 8-point pass over the last axis of (N, 8, 8) float32, out[j] =
    sum_k x[k] d8[k][j] as the kernel sums it: the even-k and the odd-k
    terms apart, each by fmaf in index order from 0, then out[j] = E + O
    and out[7 - j] = E - O (rows of d8 are even or odd about j = 3.5)."""
    ev = np.zeros(x.shape[:-1] + (4,), np.float32)
    od = np.zeros_like(ev)
    for k in range(0, 8, 2):
        ev = _fma32(x[..., k:k + 1], d8[k][None, None, :4], ev)
        od = _fma32(x[..., k + 1:k + 2], d8[k + 1][None, None, :4], od)
    return np.concatenate([ev + od, (ev - od)[..., ::-1]], -1)


def separable_f32(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The kernel's order: X = f32(x) * q in natural order, the column
    pass over v, the row pass over u, then + 128; (N, 64) raster
    float32."""
    d8 = ref_dct8_matrix().astype(np.float32)
    np.testing.assert_array_equal(d8[:, 4:], d8[:, 3::-1] * np.where(
        np.arange(8) % 2, -1, 1).astype(np.float32)[:, None])
    X = np.zeros((x.shape[0], 64), np.float32)
    X[:, REF_ZIGZAG] = x.astype(np.float32) * q.astype(np.float32)
    X = X.reshape(-1, 8, 8)
    t = _pass(X.transpose(0, 2, 1), d8).transpose(0, 2, 1)
    f = _pass(t, d8)
    return (f.reshape(-1, 64) + np.float32(128)).astype(np.float32)


def _blocks(q: int) -> np.ndarray:
    """(N, 64) int32 zig-zag coefficients: photo-like blocks (smooth
    ramps with a little noise, quantised at ``q``), noise falling with
    frequency, and extremes (|x| up to 2047 everywhere or at one place,
    a lone DC, all zero)."""
    rng = np.random.default_rng(23)
    y, x = np.mgrid[0:8, 0:8]
    px = np.stack([np.clip(a * x + b * y + c + rng.normal(0, 4, (8, 8)), 0,
                           255).reshape(64)
                   for a, b, c in rng.integers(-30, 30, (96, 3))
                   + np.array([0, 0, 128])])
    M, b = ref_fdct_quant_matrix(ref_quant_table_zz(ComponentType.LUMINANCE,
                                                    q))
    photo = np.rint(px @ M - b)
    scale = 400.0 / (1.0 + np.arange(64))
    noise = np.rint(rng.normal(0, 1, (96, 64)) * scale)
    full = rng.choice([-2047, 2047], (8, 64))
    lone = np.zeros((12, 64))
    lone[np.arange(12), rng.integers(0, 64, 12)] = rng.choice(
        [-2047, -1024, 1023, 2047], 12)
    dc = np.zeros((6, 64))
    dc[:, 0] = [-2047, -1024, -1, 0, 1023, 2047]
    return np.concatenate([photo, noise, full, lone, dc]).astype(np.int32)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("ct", (ComponentType.LUMINANCE,
                                ComponentType.CHROMINANCE))
def test_separable_order_within_the_f32_bound(q, ct):
    qz = ref_quant_table_zz(ct, q)
    x = _blocks(q)
    W64 = ref_idct_dequant(qz)
    y64 = x.astype(np.float64) @ W64 + 128.0
    eps = F32_DOT_REL * (np.abs(x).astype(np.float64) @ np.abs(W64) + 128.0)

    y_sep = separable_f32(x, qz).astype(np.float64)
    wq = torch.as_tensor(W64.astype(np.float32))
    y_plain = (torch.matmul(torch.from_numpy(x).float(), wq)
               + 128.0).double().numpy()
    assert (np.abs(y_sep - y64) <= eps).all()
    assert (np.abs(y_sep - y_plain) <= 2 * eps).all()

    # the pixels: the separable order's against the plain D2's, and both
    # against the float64 golden value
    px_sep = np.clip(np.rint(y_sep), 0, 255)
    px_plain = np.clip(np.rint(y_plain), 0, 255)
    far = np.abs(y64 - np.floor(y64) - 0.5)
    d = np.abs(px_sep - px_plain)
    assert d.max(initial=0) <= 1
    assert (far[d != 0] <= 2 * eps[d != 0]).all()
    gold = np.clip(np.rint(y64), 0, 255)
    dg = px_sep != gold
    assert (far[dg] <= eps[dg]).all()


def _context(q: int):
    import gpujpeg_tpu_torch as port
    from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
    from gpujpeg_tpu_torch.ops.pipeline import dec_context
    from gpujpeg_tpu_torch.stream.reader import read_image
    image = port.ImageParameters(width=16, height=16,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    img = np.random.default_rng(q).integers(0, 256, (16, 16, 3),
                                            dtype=np.uint8)
    data = port.Encoder(backend="golden").encode(
        img.reshape(-1), port.Parameters(quality=q, restart_interval=1),
        image)
    info = read_image(data)
    plan, _, _ = plan_from_info(info)
    return dec_context({}, plan, info, *huffman_maps(info), image,
                       torch.device("cpu"))


@pytest.mark.parametrize("q", (75, 100))
def test_quant_is_the_table_of_wq(q):
    """``DecodeTables.quant`` holds the zig-zag tables ``wq`` was built
    from: the unit operator scaled by them, in float32, is ``wq``."""
    t = _context(q).tables
    # Q75: a luma and a chroma table; Q100: both all ones, deduplicated
    assert t.quant.dtype == torch.float32
    assert t.quant.shape == (2 if q == 75 else 1, 64)
    quant = t.quant.numpy().astype(np.float64)
    assert np.array_equal(quant, np.rint(quant))
    unit = ref_idct_dequant(np.ones(64))
    for k in range(quant.shape[0]):
        np.testing.assert_array_equal(
            (unit * quant[k][:, None]).astype(np.float32), t.wq[k].numpy())


def test_idct_rgb_on_the_cpu_is_plain_and_checks_quant():
    ctx = _context(75)
    t = ctx.tables
    coeff = torch.from_numpy(np.random.default_rng(4).integers(
        -60, 60, (12, 64)).astype(np.int32))
    xf = transform_consts_tensor((None, None), "cpu")
    d2 = (coeff, t.quant, t.q_of, xf, False, 16, 16)
    assert torch.equal(dct.idct_rgb(*d2), dct.idct_rgb_plain(*d2))
    for bad in (t.quant.double(), t.quant[:, :32].contiguous(), t.quant[None],
                torch.cat([t.quant] * 2), t.quant.to(torch.int32)):
        with pytest.raises(ValueError, match="quant"):
            dct.idct_rgb(coeff, bad, t.q_of, xf, False, 16, 16)


# ---------------------------------------------------------------------------
# D2p: the same order over the scan-order blocks of any plan
# ---------------------------------------------------------------------------

#: name -> (input pixel format, sampling, interleaved)
PLANS = {
    "420i": ("PF_444_U8_P012", 420, True),
    "422": ("PF_444_U8_P012", 422, False),
    "gray": ("U8", 444, False),
    "444-rgb": ("PF_444_U8_P012", 444, False),
}
SIZES = ((17, 13), (200, 136))


def _rgb_out(plan):
    """Interleaved RGB output of the plan's size."""
    import gpujpeg_tpu_torch as port
    return port.ImageParameters(
        width=plan.image.width, height=plan.image.height,
        color_space=port.ColorSpace.RGB,
        pixel_format=port.PixelFormat.PF_444_U8_P012)


def _plan_parts(name, w, h, interleaved=None, q=85):
    """(info, plan, decode context to RGB on the CPU, D1's scan-order
    coefficients) of the golden encoder's stream of one PLANS entry."""
    import gpujpeg_tpu_torch as port
    from conftest import make_test_rgb
    from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
    from gpujpeg_tpu_torch.ops.decode import build_rows
    from gpujpeg_tpu_torch.ops.pipeline import dec_context
    from gpujpeg_tpu_torch.stream.reader import read_image
    pf, sub, inter = PLANS[name]
    inter = inter if interleaved is None else interleaved
    img = make_test_rgb(h, w, seed=w + h)
    raw = img[..., 0].reshape(-1) if pf == "U8" else img.reshape(-1)
    data = port.Encoder(backend="golden").encode(
        raw, port.Parameters(quality=q, restart_interval=2,
                             interleaved=inter).with_chroma_subsampling(sub),
        port.ImageParameters(width=w, height=h,
                             pixel_format=port.PixelFormat[pf]))
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    ctx = dec_context({}, plan, info, *huffman_maps(info), _rgb_out(plan),
                      torch.device("cpu"))
    coeff = ctx.coefficients(torch.from_numpy(build_rows(plan, scan_data,
                                                         segs)))
    return info, plan, ctx, coeff


def _block_geometry(plan):
    from gpujpeg_tpu_torch.ops.preprocess import block_geometry
    return block_geometry(plan, "cpu")


def _scan_tables(ctx, b):
    """(NB, 64) float64 zig-zag quant table of each scan-order block."""
    rows = b.blk.tolist()
    first = torch.tensor([r[2] for r in rows])
    comp = torch.searchsorted(first, b.block_plane_idx.long(), right=True) - 1
    t = ctx.tables
    return t.quant.double().numpy()[t.q_of.long().numpy()[comp.numpy()]]


def _render_d2p(ctx, plan, coeff):
    """The kernel's order on the scan-order coefficients, rounded,
    clamped and written to the planes: the flat planes (E0's layout)."""
    from gpujpeg_tpu_torch.ops.blocks import blocks_to_plane
    b = _block_geometry(plan)
    y = separable_f32(coeff.numpy(), _scan_tables(ctx, b))
    px = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    blocks = np.empty_like(px)
    blocks[b.block_plane_idx.long().numpy()] = px
    rows = b.blk.tolist()
    ends = [r[0] for r in rows[1:]] + [b.total]
    return torch.cat([
        blocks_to_plane(torch.from_numpy(blocks[pb:pb + (e - off) // 64]),
                        (e - off) // dw, dw).reshape(-1)
        for (off, dw, pb, _), e in zip(rows, ends)])


def _assert_value_ties(a, b_planes, ctx, plan, coeff):
    """Two float32 evaluations' planes may differ only by 1, and only
    where the float64 IDCT value + 128 lies within twice the bound
    ``eps = F32_DOT_REL * (|x| @ |W| + 128)`` of .5; compared per
    scan-order block."""
    b = _block_geometry(plan)
    ga, _ = dct.scan_order_blocks(torch.as_tensor(a), b.blk,
                                  b.block_plane_idx)
    gb, _ = dct.scan_order_blocks(torch.as_tensor(b_planes), b.blk,
                                  b.block_plane_idx)
    d = np.abs(ga.numpy().astype(np.int64) - gb.numpy())
    assert d.max(initial=0) <= 1
    rows = np.nonzero(d.any(1))[0]
    if rows.size == 0:
        return
    qz = _scan_tables(ctx, b)[rows]
    x = coeff.numpy()[rows].astype(np.float64)
    W = np.stack([ref_idct_dequant(q) for q in qz])
    y64 = np.einsum("nk,nkp->np", x, W) + 128.0
    eps = F32_DOT_REL * (np.einsum("nk,nkp->np", np.abs(x), np.abs(W))
                         + 128.0)
    far = np.abs(y64 - np.floor(y64) - 0.5)
    m = d[rows] != 0
    assert (far[m] <= 2 * eps[m]).all()


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("name", list(PLANS))
def test_d2p_order_on_scan_order_blocks(name, w, h):
    """D2p's order over the plan's scan-order blocks against the plain
    D2p (the dense float32 operators) and against the JAX package's plan
    tail, by the float32 tie rule."""
    from test_torch_decode_general import _xla_planes
    info, plan, ctx, coeff = _plan_parts(name, w, h)
    assert len(plan.components) == (1 if name == "gray" else 3)
    got = _render_d2p(ctx, plan, coeff)
    b = _block_geometry(plan)
    t = ctx.tables
    plain = dct.idct_planes_plain(coeff, t.quant, t.q_of, b.blk,
                                  b.block_plane_idx, b.total)
    assert got.shape == plain.shape == (b.total,)
    _assert_value_ties(got, plain, ctx, plan, coeff)
    _assert_value_ties(got, _xla_planes(info, plan, coeff.numpy()), ctx,
                       plan, coeff)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("name", list(PLANS))
def test_plain_d2p_from_quant_equals_wq(name, w, h):
    """The plain D2p builds its operators from ``quant``; its planes equal
    those of the ``wq`` operators it took before, bit for bit."""
    from gpujpeg_tpu_torch.ops.blocks import blocks_to_plane
    _, plan, ctx, coeff = _plan_parts(name, w, h)
    b = _block_geometry(plan)
    t = ctx.tables
    got = dct.idct_planes_plain(coeff, t.quant, t.q_of, b.blk,
                                b.block_plane_idx, b.total)
    # the former plain D2p: per plane, a float32 matmul by wq[q_of[c]]
    rows = b.blk.tolist()
    idx = b.block_plane_idx.long()
    first = torch.tensor([r[2] for r in rows])
    comp = torch.searchsorted(first, idx, right=True) - 1
    px = torch.empty(coeff.shape, dtype=torch.uint8)
    for c, q in enumerate(t.q_of.tolist()):
        sel = torch.nonzero(comp == c)[:, 0]
        y = torch.matmul(coeff[sel].float(), t.wq[q]) + 128.0
        px[sel] = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    blocks = torch.empty_like(px)
    blocks[idx] = px
    ends = [r[0] for r in rows[1:]] + [b.total]
    expect = torch.cat([
        blocks_to_plane(blocks[pb:pb + (e - off) // 64], (e - off) // dw,
                        dw).reshape(-1)
        for (off, dw, pb, _), e in zip(rows, ends)])
    assert torch.equal(got, expect)


@pytest.mark.parametrize("interleaved", (False, True))
def test_d2p_order_and_d3_equal_d2(interleaved):
    """On 4:4:4 RGB, D2p's order written to the planes and the plain D3 to
    RGB equal D2's order with its colour transform, bit for bit: the
    kernels share the passes and the arithmetic, so they must agree."""
    from gpujpeg_tpu_torch.ops.preprocess import (
        out_geometry, postprocess_planes_plain)
    from gpujpeg_tpu_torch.ops.rgbpack import planes_to_rgb
    w, h = SIZES[1]
    _, plan, ctx, coeff = _plan_parts("444-rgb", w, h, interleaved)
    assert ctx.rgb_route and ctx.interleaved == interleaved
    # D2's order on its own scan order (component-major, or Y/Cb/Cr per
    # block position), then its integer inverse transform
    t = ctx.tables
    nblk = (h // 8) * (w // 8)
    x = coeff.numpy().reshape((nblk, 3, 64) if interleaved
                              else (3, nblk, 64))
    if interleaved:
        x = x.transpose(1, 0, 2)
    q = t.quant.numpy()[t.q_of.long().numpy()]
    px = np.stack([np.clip(np.rint(separable_f32(x[c], q[c])), 0, 255)
                   for c in range(3)]).astype(np.int32)
    planes = (torch.from_numpy(px).view(3, h // 8, w // 8, 8, 8)
              .permute(0, 1, 3, 2, 4).reshape(3, h, w))
    vals = ctx.xf.tolist()
    d2 = planes_to_rgb(planes, (None, None) if vals[12]
                       else (vals[:9], vals[9:12]))
    d2p = postprocess_planes_plain(_render_d2p(ctx, plan, coeff),
                                   out_geometry(plan, _rgb_out(plan), "cpu"))
    assert torch.equal(d2p.view(h, w, 3), d2.view(h, w, 3))
