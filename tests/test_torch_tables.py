"""Carrying the reference's tables across: ``tables.device_tables`` turns
the JAX package's NumPy tables into the port's tensors, and the port's
encode with those tensors matches the reference's encode."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops.entropy_v2 import build_packed_tables as ref_packed
from gpujpeg_tpu.tables import dct_zigzag_operator as ref_dct
from gpujpeg_tpu_torch.ops.pipeline import EncContext, upload_rgb
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.stream.writer import assemble, scan_bodies
from gpujpeg_tpu_torch.tables import device_tables


def _ref_tables(q):
    return ref.Encoder(backend="golden")._tables(
        ref.Parameters(quality=q, restart_interval=2))


@pytest.mark.parametrize("q", [10, 75, 100])
def test_device_tables_carry_reference_tables(q):
    quant_zz, huff = _ref_tables(q)
    t = device_tables(quant_zz, huff, torch.device("cpu"))
    for qi, table in quant_zz.items():
        np.testing.assert_array_equal(t.quant_zz[qi].numpy(), table)
        np.testing.assert_array_equal(
            t.qdiv[qi].numpy(), np.maximum(table, 1).astype(np.float32))
        assert t.quant_zz[qi].dtype == torch.int32
    for key, table in huff.items():
        codes, sizes = t.huff[key].numpy()
        np.testing.assert_array_equal(codes, table.ehufco)
        np.testing.assert_array_equal(sizes, table.ehufsi)
    packed = ref_packed(huff)
    np.testing.assert_array_equal(t.ac512.numpy(), packed.ac512)
    np.testing.assert_array_equal(t.dc64.numpy(), packed.dc64)
    D64, bias64 = ref_dct()
    np.testing.assert_array_equal(t.dct.numpy(), D64.astype(np.float32))
    np.testing.assert_array_equal(t.bias.numpy(), bias64.astype(np.float32))
    assert t.dct.dtype == t.bias.dtype == t.qdiv.dtype == torch.float32


@pytest.mark.parametrize("interleaved", [False, True])
def test_port_encode_with_reference_tables_matches_reference(interleaved):
    h, w, q, ri = 48, 64, 80, 4
    img = make_test_rgb(h, w)
    rimage = ref.ImageParameters(width=w, height=h,
                                 color_space=ref.ColorSpace.RGB,
                                 pixel_format=ref.PixelFormat.PF_444_U8_P012)
    rparams = ref.Parameters(quality=q, restart_interval=ri,
                             interleaved=interleaved)
    enc = ref.Encoder(backend="jax")
    expect = enc.encode(img.reshape(-1), rparams, rimage)
    quant_zz, huff = enc._tables(rparams)

    # the port's device encode, fed the reference's own table objects
    image = port.ImageParameters(width=w, height=h,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    params = port.Parameters(quality=q, restart_interval=ri,
                             interleaved=interleaved)
    plan = make_plan(params, image)
    ctx = EncContext(plan, quant_zz, huff, torch.device("cpu"))
    out, out_len, _, _ = ctx.run(upload_rgb(img, plan, ctx.device))
    bodies, sizes = scan_bodies(plan, [ctx.compact(out, out_len.numpy())])
    got = assemble(plan, quant_zz, huff, bodies, sizes)
    assert got == expect


@pytest.mark.parametrize("q", [50, 100])
def test_decode_tables_carry_reference_tables(q):
    """The reference's own decode tables, slots and IDCT operators, as the
    port's tensors, decode the same coefficients and pixels as the
    port's tables."""
    from gpujpeg_tpu.ops.dct import idct_operator_f32 as ref_idct
    from gpujpeg_tpu.ops.pallas_decode import build_dec_tables_v2 as ref_dec
    from gpujpeg_tpu.tables import quant_table_zz as ref_quant_zz
    from gpujpeg_tpu.stream.reader import read_image as ref_read
    from gpujpeg_tpu.models.decoder import huffman_maps as ref_maps
    from gpujpeg_tpu_torch.models.decoder import huffman_maps, plan_from_info
    from gpujpeg_tpu_torch.ops import dct, decode
    from gpujpeg_tpu_torch.ops.pipeline import dec_context
    from gpujpeg_tpu_torch.stream.reader import read_image
    from gpujpeg_tpu_torch.tables import decode_device_tables

    h, w = 64, 80
    img = make_test_rgb(h, w)
    image = port.ImageParameters(width=w, height=h,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    params = port.Parameters(quality=q, restart_interval=2)
    data = port.Encoder(backend="golden").encode(img.reshape(-1), params,
                                                 image)
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    ctx = dec_context({}, plan, info, *huffman_maps(info), image,
                      torch.device("cpu"))

    rinfo = ref_read(data)
    uniq, dc_slot, ac_slot = decode.table_slots(plan, *ref_maps(rinfo))
    qts, q_of = decode.quant_slots(plan, rinfo)
    ref_tabs = ref_dec(uniq)
    # the quant tables the stream was written with, as the JAX package
    # builds them (luma, chroma; one table where they are equal)
    ref_quant = list(dict.fromkeys(
        tuple(int(v) for v in ref_quant_zz(ct, q))
        for ct in (ref.ComponentType.LUMINANCE,
                   ref.ComponentType.CHROMINANCE)))
    ref_t = dataclasses.replace(
        decode_device_tables(ref_tabs, decode.wide_quick_tables(ref_tabs),
                             dc_slot, ac_slot, qts, q_of,
                             torch.device("cpu")),
        wq=torch.as_tensor(np.stack([ref_idct(k) for k in qts])),
        quant=torch.tensor(ref_quant, dtype=torch.float32))
    for name in ("wide", "maxcode", "delta", "huffval", "dc_slot",
                 "ac_slot", "wq", "quant", "q_of"):
        assert torch.equal(getattr(ref_t, name), getattr(ctx.tables, name))
    # the wide table extends the reference's quick table: an 11-bit
    # prefix whose 8-bit prefix hits there holds the same entry
    quick = torch.as_tensor(ref_tabs.quick)
    hit = (quick & 31) > 0
    wide = ctx.tables.wide.view(quick.shape[0], 256, -1)
    assert hit.any()
    assert torch.equal(wide[hit], quick[hit][:, None].expand(
        -1, wide.shape[2]))

    rows = torch.from_numpy(decode.build_rows(plan, scan_data, segs))
    outs = []
    for t in (ref_t, ctx.tables):
        coeff = decode.huffman_decode(
            rows, ctx.seg_start, ctx.seg_count, ctx.block_comp, t.wide,
            t.maxcode, t.delta, t.huffval, t.dc_slot, t.ac_slot)
        outs.append((coeff, dct.idct_rgb(coeff, t.quant, t.q_of, ctx.xf,
                                         False, h, w)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
