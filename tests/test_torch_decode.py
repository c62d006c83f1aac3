"""The port's device decode (plain torch versions of D1 and D2 on the CPU)
against the JAX package: coefficients against the golden decoder, pixels
against the JAX IDCT tail, and whole decodes against the JAX decoder
running K2/K3 (and K4) in Pallas interpret mode, corrupt streams
included. The plan tail (D2p + D3) has its own file,
``test_torch_decode_general.py``."""
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu.models.decoder as ref_dmod
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
from gpujpeg_tpu.ops import golden as ref_golden
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu.stream.reader import read_image as ref_read_image
from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
from gpujpeg_tpu_torch.ops import decode, dct, pipeline, preprocess as pre
from gpujpeg_tpu_torch.stream.reader import read_image
from gpujpeg_tpu_torch.tables import idct_dequant_matrix

CPU = torch.device("cpu")
#: a float32 IDCT sum may round the other way than another summation
#: order only where the float64 value lies this close to .5
TIE_EPS = 1e-3
#: one component step of +-1 moves an output byte of the default inverse
#: transform (BT.601 full range, largest factor 454/256 * 256/255 < 2) by
#: at most 2
MAX_TIE_STEP = 2
#: differing pixels may be at most this share of the frame
MAX_TIE_SHARE = 1e-2


def _setup(mod, w, h, q, ri, interleaved=False):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012)
    return mod.Parameters(quality=q, restart_interval=ri,
                          interleaved=interleaved), image


def _stream(h, w, q, ri, interleaved=False, sub=None):
    img = make_test_rgb(h, w)
    params, image = _setup(port, w, h, q, ri, interleaved)
    if sub is not None:
        params = params.with_chroma_subsampling(sub)
    return port.Encoder(backend="golden").encode(img.reshape(-1), params,
                                                 image)


def _port_parts(data):
    """The port's decode operands of a stream on the CPU."""
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    dc, ac = huffman_maps(info)
    out_image = port.ImageParameters(
        width=info.width, height=info.height, color_space=port.ColorSpace.RGB,
        pixel_format=port.PixelFormat.PF_444_U8_P012)
    ctx = pipeline.dec_context({}, plan, info, dc, ac, out_image, CPU)
    rows = torch.from_numpy(decode.build_rows(plan, scan_data, segs))
    return info, plan, ctx, rows


def _d1(ctx, rows):
    t = ctx.tables
    return decode.huffman_decode(rows, ctx.seg_start, ctx.seg_count,
                                 ctx.block_comp, t.wide, t.maxcode, t.delta,
                                 t.huffval, t.dc_slot, t.ac_slot)


def _golden_coeff(data):
    info = ref_read_image(data)
    dec = ref.Decoder(backend="golden")
    plan, scan_data, segs = dec._plan_from_info(info)
    dc, ac = ref_dmod.huffman_maps(info)
    return ref_golden.decode_segments(plan, scan_data, segs, dc, ac)


def _assert_ties(got, expect, coeff, plan, info):
    """``got`` and ``expect`` (H, W, 3) uint8 may differ only at pixels
    where a component's float64 IDCT value lies within TIE_EPS of .5,
    by at most MAX_TIE_STEP, on at most MAX_TIE_SHARE of the pixels."""
    got, expect = np.asarray(got), np.asarray(expect)
    H, W, _ = got.shape
    d = np.abs(got.astype(np.int64) - expect.astype(np.int64))
    ys, xs = np.nonzero(d.max(axis=2))
    if ys.size == 0:
        return
    assert d.max() <= MAX_TIE_STEP
    assert ys.size <= MAX_TIE_SHARE * H * W
    nbx = W // 8
    pos = (ys // 8) * nbx + xs // 8
    p = (ys % 8) * 8 + xs % 8
    dist = np.full(ys.size, np.inf)
    coeff = np.asarray(coeff)
    scan_of_plane = np.argsort(plan.block_plane_idx)
    for c in plan.components:
        qt = info.quant_tables[info.components[c.index].quant_table_index]
        W64 = idct_dequant_matrix(np.asarray(qt))
        scan_row = scan_of_plane[c.index * (plan.n_blocks // 3) + pos]
        y = np.einsum("nk,nk->n", coeff[scan_row].astype(np.float64),
                      W64[:, p].T) + 128.0
        dist = np.minimum(dist, np.abs(y - np.floor(y) - 0.5))
    assert dist.max() < TIE_EPS, dist.max()


def _assert_plane_ties(got, expect, coeff, plan, info):
    """Two flat plane arrays of one plan (D2p's layout: every component's
    MCU-padded plane, concatenated) may differ only by 1, where the
    float64 IDCT value of the component lies within TIE_EPS of .5, on at
    most MAX_TIE_SHARE of the values."""
    got, expect = np.asarray(got), np.asarray(expect)
    assert got.shape == expect.shape
    d = np.abs(got.astype(np.int64) - expect.astype(np.int64))
    idx = np.flatnonzero(d)
    if idx.size == 0:
        return
    assert d.max() <= 1
    assert idx.size <= MAX_TIE_SHARE * got.size
    inv = np.empty(plan.n_blocks, np.int64)
    inv[plan.block_plane_idx] = np.arange(plan.n_blocks)
    coeff = np.asarray(coeff)
    off = 0
    for c in plan.components:
        n = c.data_width * c.data_height
        local = idx[(idx >= off) & (idx < off + n)] - off
        r, col = local // c.data_width, local % c.data_width
        pb = c.plane_block_offset + (r // 8) * c.block_count_x + col // 8
        p = (r % 8) * 8 + col % 8
        W64 = idct_dequant_matrix(np.asarray(
            info.quant_tables[info.components[c.index].quant_table_index]))
        y = np.einsum("nk,nk->n", coeff[inv[pb]].astype(np.float64),
                      W64[:, p].T) + 128.0
        assert np.all(np.abs(y - np.floor(y) - 0.5) < TIE_EPS)
        off += n


def _golden_planes(info, plan, coeff):
    """The JAX package's golden decoder's flat planes (float64 IDCT) of
    scan-order coefficients, in D2p's layout."""
    from gpujpeg_tpu.ops.blocks import blocks_to_plane
    coeff = np.asarray(coeff)
    coeff_plane = np.empty_like(coeff)
    coeff_plane[plan.block_plane_idx] = coeff
    return np.concatenate([
        blocks_to_plane(ref_golden.dequant_idct(
            coeff_plane[c.plane_block_offset:
                        c.plane_block_offset + c.block_count],
            info.quant_tables[info.components[c.index].quant_table_index]),
            c.data_height, c.data_width, np).reshape(-1)
        for c in plan.components])


# ---------------------------------------------------------------------------
# (a) D1 against the golden decoder, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,q,ri,interleaved", [
    (64, 80, 85, 2, False),
    (128, 512, 75, 32, False),
    (256, 256, 90, 32, False),
    (64, 80, 85, 4, True),
    (64, 80, 100, 2, False),
])
def test_plain_d1_matches_golden_coefficients(h, w, q, ri, interleaved):
    data = _stream(h, w, q, ri, interleaved)
    info, plan, ctx, rows = _port_parts(data)
    coeff = _d1(ctx, rows).numpy()
    np.testing.assert_array_equal(coeff, _golden_coeff(data))
    if q == 100:
        # codes longer than the 8-bit quick table: the slow path ran
        assert _longest_ac_code(coeff, plan, huffman_maps(info)[1]) > 8


def _longest_ac_code(coeff, plan, ac_by_comp) -> int:
    """Length of the longest AC Huffman code in the coded blocks."""
    longest = 0
    for blk, comp in zip(coeff, plan.block_comp):
        sizes = ac_by_comp[comp].ehufsi
        run = 0
        for v in blk[1:]:
            if v == 0:
                run += 1
                continue
            if run > 15:
                longest = max(longest, int(sizes[0xF0]))
                run &= 15
            sym = (run << 4) | int(abs(v)).bit_length()
            longest = max(longest, int(sizes[sym]))
            run = 0
    return longest


# ---------------------------------------------------------------------------
# (b) D2 against the JAX IDCT tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(64, 80), (128, 512)])
def test_plain_d2_matches_jax_tail(h, w):
    import jax.numpy as jnp
    from gpujpeg_tpu.ops.blocks import blocks_to_plane
    from gpujpeg_tpu.ops.dct import dequant_idct_device, idct_operator_f32
    from gpujpeg_tpu.ops.rgbpack import interleave_raw_words, unpack_consts

    data = _stream(h, w, 75, 4)
    info, plan, ctx, rows = _port_parts(data)
    coeff = _d1(ctx, rows)
    t = ctx.tables
    got = dct.idct_rgb(coeff, t.quant, t.q_of, ctx.xf, ctx.interleaved, h, w)
    assert got.shape == (h, w, 3) and got.dtype == torch.uint8

    rinfo = ref_read_image(data)
    rplan, _, _ = ref.Decoder(backend="golden")._plan_from_info(rinfo)
    out_image = ref.ImageParameters(width=w, height=h,
                                    color_space=ref.ColorSpace.RGB,
                                    pixel_format=ref.PixelFormat.PF_444_U8_P012)
    nblk = plan.n_blocks // 3
    words = []
    for c in rplan.components:
        qt = rinfo.quant_tables[rinfo.components[c.index].quant_table_index]
        W32 = idct_operator_f32(tuple(int(x) for x in qt))
        px = dequant_idct_device(
            jnp.asarray(coeff.numpy()[c.index * nblk:(c.index + 1) * nblk]),
            jnp.asarray(W32))
        plane = np.asarray(blocks_to_plane(px, h, w, jnp))
        words.append(jnp.asarray(np.ascontiguousarray(plane).view("<i4")))
    m9, base = unpack_consts(rplan, out_image)
    expect = np.asarray(interleave_raw_words(words, m9, base)).view("<u1")
    _assert_ties(got.numpy(), expect.reshape(h, w, 3), coeff, plan, info)


# ---------------------------------------------------------------------------
# (c)-(e) whole decodes against the JAX decoder in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """The JAX decoder on its device path with the Pallas kernels in
    interpret mode (as tests/test_pallas_interpret.py runs it), with
    fresh executable caches."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(ref_dmod, "CPU_SEGMENT_THRESHOLD", 0)
    ref_jp._DEC_CACHE.clear()
    ref_jp._DEC_V2_CACHE.clear()
    yield
    ref_jp._DEC_CACHE.clear()
    ref_jp._DEC_V2_CACHE.clear()


def _decode_both(data):
    """(port raw, JAX raw), each (H, W, 3) uint8, or the JpegParseError
    each raised."""
    out = []
    for mod, dec in ((port, port.Decoder(backend="torch", device="cpu")),
                     (ref, ref.Decoder(backend="jax"))):
        dec.set_output_format(mod.ColorSpace.RGB,
                              mod.PixelFormat.PF_444_U8_P012)
        try:
            raw, oi = dec.decode(data)
            out.append(np.asarray(raw).reshape(oi.height, oi.width, 3))
        except mod.JpegParseError as e:
            out.append(e)
    return out


def test_flagship_decode_matches_pallas_k2_k3_interpret(interpret):
    # 128x512 Q75 ri=32: the px tail's geometry (block rows hold whole
    # segments), so the JAX decode runs K2 run_pixels and K3
    data = _stream(128, 512, 75, 32)
    got, expect = _decode_both(data)
    assert any(getattr(f, "px_tail", False)
               for f in ref_jp._DEC_V2_CACHE.values())
    info, plan, ctx, rows = _port_parts(data)
    _assert_ties(got, expect, _d1(ctx, rows), plan, info)


def test_interleaved_decode_matches_pallas_template_path(interpret):
    data = _stream(64, 96, 85, 2, interleaved=True)
    got, expect = _decode_both(data)
    assert ref_jp._DEC_V2_CACHE
    info, plan, ctx, rows = _port_parts(data)
    assert plan.params.interleaved
    _assert_ties(got, expect, _d1(ctx, rows), plan, info)


@pytest.mark.parametrize("seed", [1234, 5])
def test_corrupt_stream_matches_pallas_decoder(interpret, seed):
    data = _stream(64, 80, 85, 4)
    rng = np.random.default_rng(seed)
    sos = data.find(b"\xff\xda")
    buf = bytearray(data)
    for _ in range(12):
        i = int(rng.integers(sos + 20, len(buf) - 3))
        if buf[i] != 0xFF and buf[i - 1] != 0xFF:   # keep marker structure
            buf[i] ^= 0x55
    got, expect = _decode_both(bytes(buf))
    if isinstance(expect, Exception):
        assert isinstance(got, Exception) and str(got) == str(expect)
        return
    info, plan, ctx, rows = _port_parts(bytes(buf))
    _assert_ties(got, expect, _d1(ctx, rows), plan, info)


# ---------------------------------------------------------------------------
# (f) routing and errors; (g) the round trip
# ---------------------------------------------------------------------------

def test_few_segments_take_the_golden_route(monkeypatch):
    data = _stream(64, 80, 85, 8)            # 30 segments
    assert read_image(data).restart_interval == 8

    def no_device(*a, **k):
        raise AssertionError("the device decode ran below the threshold")

    monkeypatch.setattr(pipeline, "decode_device", no_device)
    raw, _ = port.Decoder(backend="torch", device="cpu").decode(data)
    expect, _ = port.Decoder(backend="golden").decode(data)
    np.testing.assert_array_equal(raw, expect)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    with pytest.raises(AssertionError, match="threshold"):
        port.Decoder(backend="torch", device="cpu").decode(data)


def test_init_warms_the_context_of_the_first_decode():
    params, image = _setup(port, 512, 128, 75, 32)
    dec = port.Decoder(backend="torch", device="cpu")
    dec.init(params, image)
    assert len(dec._contexts) == 1 and dec.stats.bytes_memory_to > 0
    warmed = dict(dec._contexts)
    dec.decode(_stream(128, 512, 75, 32))
    assert dec._contexts == warmed


@pytest.mark.parametrize("case", ["subsampled", "grayscale"])
def test_formerly_unsupported_plans_decode(case):
    """Two plans that the decode main path's slice refused now take the
    plan tail (D1 -> D2p -> D3) and match the golden decoder: the planes
    within .5 IDCT ties, the output D3 of the planes."""
    if case == "subsampled":
        data = _stream(64, 128, 85, 1, interleaved=True, sub=420)
    else:
        data = _stream(64, 80, 85, 2)
    dec = port.Decoder(backend="torch", device="cpu")
    gold = port.Decoder(backend="golden")
    if case == "grayscale":
        for d in (dec, gold):
            d.set_output_format(port.YCBCR_JPEG, port.PixelFormat.U8)
    info, plan, ctx, rows = _port_parts(data)
    assert info.restart_interval > 0
    assert plan.n_segments >= dmod.CPU_SEGMENT_THRESHOLD  # no golden route
    raw, oi = dec.decode(data)
    expect, _ = gold.decode(data)
    assert raw.shape == expect.shape

    coeff = _d1(ctx, rows)
    b = pre.block_geometry(plan, CPU)
    t = ctx.tables
    planes = dct.idct_planes(coeff, t.quant, t.q_of, b.blk,
                             b.block_plane_idx, b.total).numpy()
    gold_planes = _golden_planes(info, plan, coeff)
    _assert_plane_ties(planes, gold_planes, coeff, plan, info)
    np.testing.assert_array_equal(raw, pre.postprocess_planes(
        torch.from_numpy(planes), pre.out_geometry(plan, oi, CPU)).numpy())
    if np.array_equal(planes, gold_planes):
        np.testing.assert_array_equal(raw, expect)


def test_round_trip_matches_golden_round_trip():
    # the torch and golden encoders may differ at .5 DCT ties (f32 vs
    # f64), so each stream is decoded by both decoders: the torch decode
    # equals the golden decode of the same stream up to IDCT ties, and
    # the torch round trip is as close to the frame as the golden one
    from conftest import psnr
    img = make_test_rgb(256, 256)
    params, image = _setup(port, 256, 256, 75, 32)
    data = port.Encoder(backend="torch", device="cpu").encode(
        img.reshape(-1), params, image)
    gold = port.Encoder(backend="golden").encode(img.reshape(-1), params,
                                                 image)
    raw, oi = port.Decoder(backend="torch", device="cpu").decode(data)
    assert raw.dtype == np.uint8 and raw.shape == (256 * 256 * 3,)
    expect, _ = port.Decoder(backend="golden").decode(data)
    info, plan, ctx, rows = _port_parts(data)
    _assert_ties(raw.reshape(256, 256, 3), expect.reshape(256, 256, 3),
                 _d1(ctx, rows), plan, info)
    gold_rt, _ = port.Decoder(backend="golden").decode(gold)
    assert abs(psnr(raw.reshape(img.shape), img)
               - psnr(gold_rt.reshape(img.shape), img)) < 0.01
    dev, _ = port.Decoder(backend="torch", device="cpu").decode_to_device(data)
    assert isinstance(dev, torch.Tensor) and dev.device == CPU
    np.testing.assert_array_equal(dev.numpy(), raw)
