"""The port's general decode (plain D1 -> D2p idct_planes -> D3
postprocess_planes on the CPU) against the JAX package: coefficients
against the golden decoder, planes against the XLA plan tail
(``dequant_idct_device`` + ``blocks_to_plane``), and whole decodes against
the JAX decoder running K4 (and, with ``V3_WCAP_MAX = 0``, K5) in Pallas
interpret mode, each proven to have run by a counting wrapper. Plain D3
against the JAX ``postprocess`` is in ``test_torch_postprocess.py``."""
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
from gpujpeg_tpu.ops import pallas_decode as ref_pd
from gpujpeg_tpu.ops import pallas_decode_v3 as ref_v3
from gpujpeg_tpu.stream.reader import read_image as ref_read_image
from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
from gpujpeg_tpu_torch.ops import dct, pipeline, preprocess as pre
from gpujpeg_tpu_torch.stream.reader import read_image
from test_torch_decode import _assert_plane_ties, _golden_planes

CPU = torch.device("cpu")
PF, CS = port.PixelFormat, port.ColorSpace

#: name -> (height, width, quality, restart interval, interleaved,
#: sampling, input pixel format)
STREAMS = {
    "420i": (64, 96, 90, 2, True, 420, PF.PF_444_U8_P012),
    "422i": (64, 96, 90, 2, True, 422, PF.PF_444_U8_P012),
    "420": (64, 96, 90, 2, False, 420, PF.PF_444_U8_P012),
    "gray": (64, 80, 85, 2, False, 444, PF.U8),
    "4comp": (48, 64, 85, 2, True, 420, PF.PF_444_U8_P012A),
    "q100": (40, 72, 100, 4, False, 422, PF.PF_444_U8_P012),
}


def _raw(h, w, pf, seed=7):
    img = make_test_rgb(h, w, seed)
    if pf == PF.U8:
        return img[..., 0].reshape(-1)
    if pf == PF.PF_444_U8_P012A:
        alpha = make_test_rgb(h, w, seed + 1)[..., :1]
        return np.concatenate([img, alpha], axis=2).reshape(-1)
    return img.reshape(-1)


def _stream(name):
    """The JAX package's golden encoder's stream of a STREAMS entry."""
    h, w, q, ri, interleaved, sub, pf = STREAMS[name]
    params = ref.Parameters(quality=q, restart_interval=ri,
                            interleaved=interleaved
                            ).with_chroma_subsampling(sub)
    image = ref.ImageParameters(width=w, height=h,
                                pixel_format=ref.PixelFormat(int(pf)))
    return ref.Encoder(backend="golden").encode(_raw(h, w, pf), params,
                                                image)


def _out(info, pf=PF.PF_444_U8_P012, cs=CS.RGB):
    return port.ImageParameters(width=info.width, height=info.height,
                                color_space=cs, pixel_format=pf)


def _port_parts(data, out_image=None):
    """(info, plan, decode context, rows) of the port's decode of a
    stream on the CPU."""
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    ctx = pipeline.dec_context({}, plan, info, *huffman_maps(info),
                               out_image or _out(info), CPU)
    rows = torch.from_numpy(ctx.rows(scan_data, segs))
    return info, plan, ctx, rows


def _planes(ctx, plan, coeff):
    """Plain D2p of scan-order coefficients: the flat planes."""
    t = ctx.tables
    b = pre.block_geometry(plan, CPU)
    return dct.idct_planes(coeff, t.quant, t.q_of, b.blk, b.block_plane_idx,
                           b.total)


def _xla_planes(info, plan, coeff):
    """The JAX plan tail after K4/K5 on the same coefficients: the scan
    -> plane gather, ``dequant_idct_device`` and ``blocks_to_plane`` per
    component, flat."""
    import jax.numpy as jnp
    from gpujpeg_tpu.ops.blocks import blocks_to_plane
    from gpujpeg_tpu.ops.dct import dequant_idct_device, idct_operator_f32
    coeff_plane = np.empty_like(coeff)
    coeff_plane[plan.block_plane_idx] = coeff
    out, pos = [], 0
    for c in plan.components:
        qt = info.quant_tables[info.components[c.index].quant_table_index]
        px = dequant_idct_device(
            jnp.asarray(coeff_plane[pos:pos + c.block_count]),
            jnp.asarray(idct_operator_f32(tuple(int(x) for x in qt))))
        out.append(np.asarray(blocks_to_plane(px, c.data_height,
                                              c.data_width, jnp)).reshape(-1))
        pos += c.block_count
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# 1-2: plain D1 against the golden decoder, plain D2p against the XLA tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STREAMS))
def test_plain_d1_matches_golden_coefficients(name):
    data = _stream(name)
    info, plan, ctx, rows = _port_parts(data)
    coeff = ctx.coefficients(rows).numpy()
    rinfo = ref_read_image(data)
    rplan, scan_data, segs = ref.Decoder(backend="golden")._plan_from_info(
        rinfo)
    np.testing.assert_array_equal(coeff, ref_golden.decode_segments(
        rplan, scan_data, segs, *ref_dmod.huffman_maps(rinfo)))
    assert len(plan.components) == {"gray": 1, "4comp": 4}.get(name, 3)


@pytest.mark.parametrize("name", list(STREAMS))
def test_plain_d2p_matches_xla_plan_tail(name):
    data = _stream(name)
    info, plan, ctx, rows = _port_parts(data)
    coeff = ctx.coefficients(rows)
    got = _planes(ctx, plan, coeff)
    assert got.dtype == torch.uint8
    assert got.numel() == sum(c.data_width * c.data_height
                              for c in plan.components)
    _assert_plane_ties(got.numpy(), _xla_planes(info, plan, coeff.numpy()),
                       coeff.numpy(), plan, info)


def test_zero_words_past_a_segment_are_harmless():
    """The JAX package rounds row widths up (``bucket_wcap``); the port
    does not, and D1 must not care."""
    info, plan, ctx, rows = _port_parts(_stream("420i"))
    wide = torch.cat([rows, torch.zeros((rows.shape[0], 128 - rows.shape[1]
                                         % 128), dtype=rows.dtype)], 1)
    torch.testing.assert_close(ctx.coefficients(wide),
                               ctx.coefficients(rows), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# 4, 5, 7: whole decodes against the JAX decoder in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """The JAX decoder on its device path with the Pallas kernels in
    interpret mode, no golden route, fresh executable caches, and
    counting wrappers on the functions that make K4 (v3) and K5 (v2)."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(ref_dmod, "CPU_SEGMENT_THRESHOLD", 0)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    built = {"v3": 0, "v2": 0}

    def counting(key, fn):
        def wrapper(*a, **kw):
            built[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ref_v3, "make_decode_kernel_v3",
                        counting("v3", ref_v3.make_decode_kernel_v3))
    monkeypatch.setattr(ref_pd, "make_decode_kernel",
                        counting("v2", ref_pd.make_decode_kernel))
    ref_jp._DEC_CACHE.clear()
    ref_jp._DEC_V2_CACHE.clear()
    yield built
    ref_jp._DEC_CACHE.clear()
    ref_jp._DEC_V2_CACHE.clear()


def _decode_both(data, pf, cs):
    """(port raw, JAX raw) of one output format, or the JpegParseError
    each raised."""
    out = []
    for mod, dec in ((port, port.Decoder(backend="torch", device="cpu")),
                     (ref, ref.Decoder(backend="jax"))):
        dec.set_output_format(mod.ColorSpace(int(cs)),
                              mod.PixelFormat(int(pf)))
        try:
            out.append(np.asarray(dec.decode(data)[0]))
        except mod.JpegParseError as e:
            out.append(e)
    return out


def _assert_decodes_agree(data, pf, cs, got, expect):
    """The port's output is D3 of its own planes, the JAX decoder's is
    D3 of the XLA planes of the same coefficients (so K4/K5 gave them),
    and the two plane sets agree outside .5 ties."""
    out_image = _out(read_image(data), pf, cs)
    info, plan, ctx, rows = _port_parts(data, out_image)
    coeff = ctx.coefficients(rows)
    mine = _planes(ctx, plan, coeff)
    xla = _xla_planes(info, plan, coeff.numpy())
    _assert_plane_ties(mine.numpy(), xla, coeff.numpy(), plan, info)
    g = pre.out_geometry(plan, out_image, CPU)
    np.testing.assert_array_equal(
        got, pre.postprocess_planes(mine, g).numpy())
    np.testing.assert_array_equal(
        expect, pre.postprocess_planes(torch.from_numpy(xla), g).numpy())


def _assert_plan_tail_ran():
    assert ref_jp._DEC_V2_CACHE
    assert not any(getattr(f, "px_tail", True)
                   for f in ref_jp._DEC_V2_CACHE.values())


@pytest.mark.parametrize("name,pf,cs", [
    pytest.param("420i", PF.PF_444_U8_P012, CS.RGB, id="420i-rgb"),
    pytest.param("422i", PF.PF_422_U8_P1020, CS.YCBCR_BT709, id="422i-uyvy"),
    pytest.param("420", PF.U8, CS.RGB, id="420-u8"),
    pytest.param("420", PF.PF_420_U8_P0P1P2, CS.YCBCR_BT601_256LVLS,
                 id="420-i420"),
])
def test_decode_matches_pallas_k4_interpret(interpret, name, pf, cs):
    data = _stream(name)
    got, expect = _decode_both(data, pf, cs)
    _assert_plan_tail_ran()
    assert interpret["v3"] >= 1 and interpret["v2"] == 0
    _assert_decodes_agree(data, pf, cs, got, expect)


def test_long_segments_match_pallas_k5_interpret(interpret, monkeypatch):
    # test_decode_v2_large_wcap_kernel's stream; V3_WCAP_MAX = 0 sends
    # the JAX decode to K5 (and rounds its rows to 128-word multiples)
    h, w = 128, 160
    params = ref.Parameters(quality=92, restart_interval=16)
    image = ref.ImageParameters(width=w, height=h)
    data = ref.Encoder(backend="golden").encode(
        make_test_rgb(h, w).reshape(-1), params, image)
    monkeypatch.setattr(ref_pd, "V3_WCAP_MAX", 0)
    got, expect = _decode_both(data, PF.PF_444_U8_P012, CS.RGB)
    assert interpret["v2"] >= 1 and interpret["v3"] == 0
    _assert_plan_tail_ran()
    _, _, ctx, _ = _port_parts(data)
    assert ctx.rgb_route                 # the port took D1 -> D2
    _assert_decodes_agree(data, PF.PF_444_U8_P012, CS.RGB, got, expect)


@pytest.mark.parametrize("seed", [1234, 5])
def test_corrupt_subsampled_stream_matches_pallas_k4(interpret, seed):
    data = _stream("420i")
    rng = np.random.default_rng(seed)
    sos = data.find(b"\xff\xda")
    buf = bytearray(data)
    for _ in range(12):
        i = int(rng.integers(sos + 20, len(buf) - 3))
        if buf[i] != 0xFF and buf[i - 1] != 0xFF:   # keep marker structure
            buf[i] ^= 0x55
    got, expect = _decode_both(bytes(buf), PF.PF_444_U8_P012, CS.RGB)
    if isinstance(expect, Exception):
        assert isinstance(got, Exception) and str(got) == str(expect)
        return
    _assert_plan_tail_ran()
    _assert_decodes_agree(bytes(buf), PF.PF_444_U8_P012, CS.RGB, got,
                          expect)


# ---------------------------------------------------------------------------
# 6: the plan tail equals the D2 route; 8: no hidden failure
# ---------------------------------------------------------------------------

def test_plan_tail_matches_d2_route():
    # the px-tail pin's geometry (test_px_tail_matches_plan_tail)
    data = port.Encoder(backend="golden").encode(
        make_test_rgb(128, 512).reshape(-1),
        port.Parameters(quality=75, restart_interval=32),
        port.ImageParameters(width=512, height=128))
    info, plan, ctx, rows = _port_parts(data)
    assert ctx.rgb_route
    coeff = ctx.coefficients(rows)
    tail = pre.postprocess_planes(_planes(ctx, plan, coeff),
                                  pre.out_geometry(plan, _out(info), CPU))
    torch.testing.assert_close(tail, ctx.pixels(coeff), rtol=0, atol=0)


def test_decode_kernel_failure_is_not_hidden(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("gj_idct_planes: CUDA launch failed")

    monkeypatch.setattr(pipeline, "idct_planes", boom)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        port.Decoder(backend="torch", device="cpu").decode(_stream("420i"))


# ---------------------------------------------------------------------------
# the decoder's surface on the plan-tail route
# ---------------------------------------------------------------------------

def test_decoder_outputs_every_format_from_a_subsampled_stream(monkeypatch):
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    data = _stream("420i")
    for pf in PF:
        if pf == PF.NONE:
            continue
        dec = port.Decoder(backend="torch", device="cpu")
        gold = port.Decoder(backend="golden")
        for d in (dec, gold):
            d.set_output_format(CS.YCBCR_BT709, pf)
        raw, oi = dec.decode(data)
        np.testing.assert_array_equal(raw, gold.decode(data)[0])
        assert raw.size == pre.raw_size(oi)
        dev, _ = dec.decode_to_device(data)
        assert isinstance(dev, torch.Tensor) and dev.device == CPU
        np.testing.assert_array_equal(dev.numpy(), raw)


def test_gray_stream_to_uyvy_raises_like_postprocess(monkeypatch):
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    data = _stream("gray")
    for backend in ("torch", "golden"):
        dec = port.Decoder(backend=backend, device="cpu")
        dec.set_output_format(CS.RGB, PF.PF_422_U8_P1020)
        with pytest.raises(ValueError):
            dec.decode(data)


def test_init_warms_the_plan_tail_context():
    params = port.Parameters(quality=85, restart_interval=1,
                             interleaved=True).with_chroma_subsampling(420)
    image = port.ImageParameters(width=128, height=64,
                                 color_space=CS.YCBCR_BT709,
                                 pixel_format=PF.PF_420_U8_P0P1P2)
    dec = port.Decoder(backend="torch", device="cpu")
    dec.set_output_format(CS.YCBCR_BT709, PF.PF_420_U8_P0P1P2)
    dec.init(params, image)
    assert len(dec._contexts) == 1
    ctx = next(iter(dec._contexts.values()))
    assert not ctx.rgb_route
    warmed = dict(dec._contexts)
    raw = pre.upload_raw(np.random.default_rng(3).integers(
        0, 256, pre.raw_size(image), dtype=np.uint8), image, CPU).numpy()
    dec.decode(port.Encoder(backend="golden").encode(raw, params, image))
    assert dec._contexts == warmed


def test_plan_tail_wrappers_check_operands():
    info, plan, ctx, rows = _port_parts(_stream("420i"))
    coeff = ctx.coefficients(rows)
    t, b, g = ctx.tables, ctx.blocks, ctx.out
    planes = dct.idct_planes(coeff, t.quant, t.q_of, b.blk,
                             b.block_plane_idx, b.total)
    assert pre.postprocess_planes(planes, g).shape == (g.raw_bytes,)
    with pytest.raises(ValueError, match="device|meta"):
        dct.idct_planes(coeff.to("meta"), t.quant, t.q_of, b.blk,
                        b.block_plane_idx, b.total)
    with pytest.raises(ValueError):
        dct.idct_planes(coeff[1:], t.quant, t.q_of, b.blk,
                        b.block_plane_idx, b.total)
    with pytest.raises(ValueError, match="quant"):
        dct.idct_planes(coeff, t.quant[:, :8], t.q_of, b.blk,
                        b.block_plane_idx, b.total)
    with pytest.raises(ValueError, match="device"):
        pre.postprocess_planes(planes.to("meta"), g)
    with pytest.raises(ValueError):
        pre.postprocess_planes(planes[1:], g)
    with pytest.raises(ValueError):
        pre.postprocess_planes(planes.to(torch.int32), g)


def test_foreign_stream_without_restart_markers(monkeypatch):
    """A PIL-written 4:2:0 JPEG (no restart markers, no APP13): one
    segment per scan, which the decoder sends to the golden route below
    the block threshold; with no golden route, the lane route D1L decodes
    the scan and the plan tail matches the golden decoder outside .5
    ties."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(make_test_rgb(48, 80)).save(buf, "JPEG", quality=85)
    data = buf.getvalue()
    info = read_image(data)
    assert info.restart_interval == 0
    expect, _ = port.Decoder(backend="golden").decode(data)
    np.testing.assert_array_equal(
        port.Decoder(backend="torch", device="cpu").decode(data)[0], expect)
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    raw, oi = port.Decoder(backend="torch", device="cpu").decode(data)
    _, plan, ctx, rows = _port_parts(data, _out(info, oi.pixel_format))
    assert rows.shape[0] == 1 and not ctx.rgb_route
    coeff = ctx.coefficients(rows)
    mine = _planes(ctx, plan, coeff)
    _assert_plane_ties(mine.numpy(), _golden_planes(info, plan, coeff),
                       coeff.numpy(), plan, info)
    np.testing.assert_array_equal(raw, pre.postprocess_planes(
        mine, pre.out_geometry(plan, oi, CPU)).numpy())
