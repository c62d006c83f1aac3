"""The port's device encode (plain torch versions of E1-E3 on the CPU)
against the JAX package: coefficients against the staged XLA DCT, entropy
bytes against the golden coder, and whole streams against the JAX
encoder — through the Pallas K1 kernel in interpret mode on the flagship
geometry, and through the XLA path."""
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import golden as ref_golden
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu.types import HuffmanType
from gpujpeg_tpu_torch.ops import dct, entropy
from gpujpeg_tpu_torch.ops.pipeline import EncContext, upload_rgb
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.tables import encode_tables

CPU = torch.device("cpu")
#: a float32 quotient may round the other way than the reference's only
#: where the float64 quotient lies this close to .5
TIE_EPS = 1e-4


def _setup(mod, w, h, q, ri, interleaved=False, cs=None):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012)
    kw = {} if cs is None else {"color_space_internal": cs}
    params = mod.Parameters(quality=q, restart_interval=ri,
                            interleaved=interleaved, **kw)
    return params, image


def _port_ctx(img, q, ri, interleaved=False, cs=None):
    h, w, _ = img.shape
    params, image = _setup(port, w, h, q, ri, interleaved, cs)
    plan = make_plan(params, image)
    ctx = EncContext(plan, *encode_tables(params.quality), CPU)
    return ctx, upload_rgb(img, plan, CPU)


def _ref_segments(plan, coeff, huff):
    dc = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
    ac = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
    segs = ref_golden.encode_segments(plan, coeff, dc, ac)
    scan_n = {s.index: s.segment_count for s in plan.scans}
    out = []
    for s, data in enumerate(segs):
        idx = int(plan.seg_scan_index[s])
        if idx != scan_n[int(plan.seg_scan[s])] - 1:
            data += bytes((0xFF, 0xD0 + idx % 8))
        out.append(data)
    return out


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (as
    tests/test_pallas_interpret.py does), with fresh executable caches."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    ref_jp._ENC_CACHE.clear()
    yield
    ref_jp._ENC_CACHE.clear()


@pytest.mark.parametrize("h,w,q,ri,interleaved,cs", [
    (64, 80, 85, 2, False, None),
    (48, 64, 75, 3, True, None),
    (256, 256, 75, 32, False, None),
    (32, 48, 95, 4, False, port.ColorSpace.RGB),
])
def test_plain_e1_matches_staged_xla_dct(h, w, q, ri, interleaved, cs):
    img = make_test_rgb(h, w)
    ctx, rgb = _port_ctx(img, q, ri, interleaved, cs)
    t = ctx.tables
    coeff = dct.fdct_quant(rgb, t.dct, t.bias, ctx.qdiv, ctx.xf,
                           ctx.interleaved).numpy()

    import jax.numpy as jnp
    rparams, rimage = _setup(ref, w, h, q, ri, interleaved, cs)
    rplan = ref_make_plan(rparams, rimage)
    enc = ref.Encoder(backend="jax")
    rctx = ref_jp._enc_context(rplan, *enc._tables(rparams))
    s_pre, s_dct, _ = rctx._stage_fns
    rows = np.asarray(s_dct(s_pre(jnp.asarray(img.reshape(-1))),
                            *rctx._stage_args[0]))
    real = rctx.geo.coeff_idx < rplan.n_blocks
    expect = np.zeros_like(coeff)
    expect[rctx.geo.coeff_idx[real]] = rows[real]

    diff = coeff != expect
    assert np.abs(coeff.astype(np.int64) - expect).max(initial=0) <= 1
    if diff.any():
        # the float64 quotients of the differing coefficients
        from gpujpeg_tpu.ops.blocks import plane_to_blocks
        from gpujpeg_tpu.ops.preprocess import preprocess
        from gpujpeg_tpu.tables import fdct_quant_matrix
        quant_zz = enc._tables(rparams)[0]
        planes = preprocess(img.reshape(-1), rimage, rplan, np)
        y = np.concatenate([
            plane_to_blocks(planes[c.index], np).astype(np.float64)
            @ fdct_quant_matrix(quant_zz[c.quant_table_index])[0]
            - fdct_quant_matrix(quant_zz[c.quant_table_index])[1]
            for c in rplan.components])[rplan.block_plane_idx]
        dist = np.abs(y[diff] - np.floor(y[diff]) - 0.5)
        assert dist.max() < TIE_EPS


def _synthetic(rng, n):
    """Coefficients the photo fixtures never reach: long zero runs (ZRL),
    a lone last coefficient (no EOB), category-10 values, every AC
    nonzero, and large DC steps."""
    c = np.zeros((n, 64), np.int32)
    c[:, 0] = rng.integers(-1024, 1017, n)
    c[0::4, 63] = rng.integers(-1023, 1024, c[0::4].shape[0])
    full = rng.integers(-1023, 1024, (c[1::4].shape[0], 63))
    full[full == 0] = 7
    c[1::4, 1:] = full
    c[2::4, 17] = -1
    c[2::4, 50] = 1
    return c


@pytest.mark.parametrize("h,w,q,ri,interleaved,content", [
    (64, 80, 75, 2, False, "photo"),
    (48, 64, 85, 3, True, "photo"),
    (64, 64, 100, 4, False, "noise"),
    (32, 64, 98, 1, False, "noise"),
    (64, 64, 75, 4, False, "synthetic"),
    (48, 48, 75, 5, True, "synthetic"),
])
def test_plain_e2_e3_match_golden_segments(h, w, q, ri, interleaved,
                                           content):
    rng = np.random.default_rng(11)
    img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
           if content == "noise" else make_test_rgb(h, w))
    rparams, rimage = _setup(ref, w, h, q, ri, interleaved)
    rplan = ref_make_plan(rparams, rimage)
    quant_zz, huff = ref.Encoder(backend="golden")._tables(rparams)
    if content == "synthetic":
        coeff = _synthetic(rng, rplan.n_blocks)
    else:
        from gpujpeg_tpu.ops.blocks import plane_to_blocks
        from gpujpeg_tpu.ops.preprocess import preprocess
        planes = preprocess(img.reshape(-1), rimage, rplan, np)
        coeff = np.concatenate([
            ref_golden.fdct_quant(plane_to_blocks(planes[c.index], np),
                                  quant_zz[c.quant_table_index])
            for c in rplan.components])[rplan.block_plane_idx]

    ctx, _ = _port_ctx(img, q, ri, interleaved)
    t, g = ctx.tables, ctx.geo
    words, bits = entropy.huffman_blocks(torch.from_numpy(coeff), g.dc_pred,
                                         g.block_cls, t.ac512, t.dc64)
    out, out_len, seg_bits, n_ff = entropy.merge_stuff(
        words, bits, g.seg_start, g.seg_count, g.rst, g.has_rst, g.cap_out)
    expect = _ref_segments(rplan, coeff, huff)
    got = [out[s, :int(out_len[s])].numpy().tobytes()
           for s in range(rplan.n_segments)]
    assert got == expect
    n_stuffed = np.array([e.count(b"\xff\x00") for e in expect])
    assert int(n_ff.sum()) == int(n_stuffed.sum())
    seg_len = (seg_bits.numpy() + 7) // 8
    np.testing.assert_array_equal(
        out_len.numpy(), seg_len + n_ff.numpy() + 2 * g.has_rst.numpy())


def _encode_both(img, q, ri, interleaved=False):
    h, w, _ = img.shape
    rparams, rimage = _setup(ref, w, h, q, ri, interleaved)
    enc = ref.Encoder(backend="jax")
    expect = enc.encode(img.reshape(-1), rparams, rimage)
    rctx = ref_jp._enc_context(ref_make_plan(rparams, rimage),
                               *enc._tables(rparams))
    params, image = _setup(port, w, h, q, ri, interleaved)
    got = port.Encoder(backend="torch", device="cpu").encode(
        img.reshape(-1), params, image)
    return got, expect, rctx.fn.kind


def test_flagship_stream_matches_pallas_k1_interpret(interpret):
    # __graft_entry__.py's flagship geometry: 256x256 Q75 ri=32, the
    # words front end feeding encode_dct_fused_full (K1)
    H = W = 256
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0),
                    128 + 80 * np.cos(x / 31.0) * np.sin(y / 11.0),
                    128 + 70 * np.sin((x + y) / 41.0)], axis=-1)
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    got, expect, kind = _encode_both(img, 75, 32)
    assert kind == "fused_full_words"
    assert got == expect


@pytest.mark.parametrize("interleaved", [False, True])
def test_stream_matches_xla_path(interleaved):
    got, expect, kind = _encode_both(make_test_rgb(64, 80), 85, 2,
                                     interleaved)
    assert kind == "staged"
    assert got == expect


def test_restart_interval_zero_takes_host_coder():
    img = make_test_rgb(64, 80)
    params, image = _setup(port, 80, 64, 75, 0)
    got = port.Encoder(backend="torch", device="cpu").encode(
        img.reshape(-1), params, image)
    assert got == port.Encoder(backend="golden").encode(
        img.reshape(-1), params, image)


def test_geometry_outside_the_slice_raises():
    """4:2:0, once outside the encode slice, now takes E0 + E1p and
    equals the JAX encoder's stream; only a device context without
    restart markers raises."""
    img = make_test_rgb(64, 80)
    params, image = _setup(port, 80, 64, 75, 2)
    params = params.with_chroma_subsampling(420)
    got = port.Encoder(backend="torch", device="cpu").encode(
        img.reshape(-1), params, image)
    rparams, rimage = _setup(ref, 80, 64, 75, 2)
    assert got == ref.Encoder(backend="jax").encode(
        img.reshape(-1), rparams.with_chroma_subsampling(420), rimage)
    params0, _ = _setup(port, 80, 64, 75, 0)
    with pytest.raises(ValueError, match="restart"):
        EncContext(make_plan(params0, image),
                   *encode_tables(params0.quality), CPU)


def test_wrappers_take_plain_versions_only_on_cpu():
    img = make_test_rgb(16, 16)
    ctx, rgb = _port_ctx(img, 75, 2)
    t = ctx.tables
    with pytest.raises(ValueError, match="device"):
        dct.fdct_quant(rgb.to("meta"), t.dct.to("meta"), t.bias.to("meta"),
                       ctx.qdiv.to("meta"), ctx.xf.to("meta"), False)
    with pytest.raises(ValueError):
        dct.fdct_quant(rgb[:, :12], t.dct, t.bias, ctx.qdiv, ctx.xf, False)

    # the decode kernels' wrappers: D1 huffman_decode and D2 idct_rgb
    from gpujpeg_tpu_torch.ops import decode
    from gpujpeg_tpu_torch.tables import decode_device_tables
    tabs = decode.build_dec_tables_v2(
        [encode_tables(port.Parameters().quality)[1][k]
         for k in sorted(ctx.tables.huff)])
    slots = np.array([0, 2, 2, 0], np.int32)     # luma, chroma, chroma
    dt = decode_device_tables(tabs, decode.wide_quick_tables(tabs), slots,
                              slots + 1, [(1,) * 64, (2,) * 64],
                              np.array([0, 1, 1], np.int32), CPU)
    g = ctx.geo
    d1 = (torch.zeros((g.seg_start.shape[0], 4), dtype=torch.int32),
          g.seg_start, g.seg_count, g.block_cls, dt.wide, dt.maxcode,
          dt.delta, dt.huffval, dt.dc_slot, dt.ac_slot)
    coeff = decode.huffman_decode(*d1)
    assert coeff.shape == (g.block_cls.shape[0], 64)
    with pytest.raises(ValueError, match="device"):
        decode.huffman_decode(*(a.to("meta") for a in d1))
    with pytest.raises(ValueError):
        decode.huffman_decode(d1[0][:, :0].t(), *d1[1:])
    d2 = (coeff, dt.quant, dt.q_of, ctx.xf)
    assert dct.idct_rgb(*d2, False, 16, 16).shape == (16, 16, 3)
    with pytest.raises(ValueError, match="device"):
        dct.idct_rgb(*(a.to("meta") for a in d2), False, 16, 16)
    with pytest.raises(ValueError):
        dct.idct_rgb(*d2, False, 16, 24)
