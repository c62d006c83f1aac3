"""Carrying the reference's tables across: ``tables.device_tables`` turns
the JAX package's NumPy tables into the port's tensors, and the port's
encode with those tensors matches the reference's encode."""
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops.entropy_v2 import build_packed_tables as ref_packed
from gpujpeg_tpu.tables import dct_zigzag_operator as ref_dct
from gpujpeg_tpu_torch.ops.pipeline import (
    _EncContext, _split_scan_bodies, upload_rgb)
from gpujpeg_tpu_torch.plan import make_plan
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
    ctx = _EncContext(plan, quant_zz, huff, torch.device("cpu"))
    out, out_len, _, _ = ctx.run(upload_rgb(img, plan, ctx.device))
    bodies, sizes = _split_scan_bodies(plan, ctx, out, out_len.numpy())
    got = port.Encoder(backend="torch", device="cpu")._assemble(
        plan, quant_zz, huff, bodies, sizes)
    assert got == expect
