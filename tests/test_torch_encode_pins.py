"""The port's counterparts of the JAX package's cross-variant encode pins
(tests/test_pallas_interpret.py): on each pin's own geometry and content,
both routes of the port's encode (E1, and E0 + E1p, plain versions on the
CPU) give the stream of the JAX encoder with its Pallas kernels in
interpret mode; and a failing kernel raises instead of degrading."""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import make_test_rgb, psnr

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu_torch.ops import pipeline
from gpujpeg_tpu_torch.ops.preprocess import upload_raw
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.stream.writer import assemble, scan_bodies
from gpujpeg_tpu_torch.tables import encode_tables

CPU = torch.device("cpu")

#: (JAX pin, height, width, quality, restart interval, content, the
#: JAX route of its stream)
PINS = [
    ("test_fused_dct_kernel_matches_unfused", 64, 80, 75, 4, "photo",
     "fused"),
    ("test_full_fused_kernel_matches_separate", 128, 160, 75, 32, "photo",
     "fused_full_words"),
    ("test_full_fused_w8_matches_staged", 128, 160, 85, 16, "photo",
     "fused_full_words"),
    ("test_pallas_encode_tier_fallback_high_entropy", 48, 64, 90, 2, "noise",
     "fused"),
    ("test_encode_kernel_downgrade_chain", 128, 160, 75, 32, "photo",
     "fused_full_words"),
]


def _setup(mod, w, h, q, ri):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012)
    return mod.Parameters(quality=q, restart_interval=ri), image


def port_streams(img, q, ri):
    """The port's stream by its two routes: the encoder's (E1 for these
    RGB 4:4:4 plans) and E0 + E1p on the same context."""
    h, w, _ = img.shape
    params, image = _setup(port, w, h, q, ri)
    enc = port.Encoder(backend="torch", device="cpu")
    by_e1 = enc.encode(img.reshape(-1), params, image)
    plan = make_plan(params, image)
    quant_zz, huff = encode_tables(params.quality)
    ctx = pipeline.EncContext(plan, quant_zz, huff, CPU)
    assert ctx.rgb_route
    out, out_len, _, _ = ctx.entropy(ctx.coefficients_planes(
        upload_raw(img.reshape(-1), image, CPU)))
    bodies, sizes = scan_bodies(plan, [ctx.compact(out, out_len.numpy())])
    return by_e1, assemble(plan, quant_zz, huff, bodies, sizes)


@pytest.mark.parametrize("pin,h,w,q,ri,content,kind", PINS,
                         ids=[p[0] for p in PINS])
def test_port_matches_item5_pin(monkeypatch, pin, h, w, q, ri, content,
                                kind):
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    img = (np.random.default_rng(1234).integers(0, 256, (h, w, 3))
           .astype(np.uint8) if content == "noise" else make_test_rgb(h, w))
    rparams, rimage = _setup(ref, w, h, q, ri)
    ref_jp._ENC_CACHE.clear()
    try:
        expect = ref.Encoder(backend="jax").encode(img.reshape(-1), rparams,
                                                   rimage)
        (rctx,) = ref_jp._ENC_CACHE.values()
        assert rctx.fn.kind == kind
        # the tier pin's stream is the JAX encoder's tier-2 retry; the
        # port has one worst-case tier
        assert (rctx._tier2 is not None) == (content == "noise")
    finally:
        ref_jp._ENC_CACHE.clear()
    by_e1, by_e0 = port_streams(img, q, ri)
    assert by_e1 == expect
    assert by_e0 == expect
    pil = np.asarray(Image.open(io.BytesIO(by_e1)).convert("RGB"))
    assert psnr(pil, img) > 25


def test_kernel_failure_is_not_hidden(monkeypatch):
    """The port has no downgrade chain: a kernel that fails raises out of
    ``encode`` (the JAX package would rebuild a simpler variant)."""
    def boom(*a, **kw):
        raise RuntimeError("gj_fdct_quant_planes: CUDA launch failed")

    monkeypatch.setattr(pipeline, "fdct_quant_planes", boom)
    img = make_test_rgb(32, 48)
    params, image = _setup(port, 48, 32, 75, 2)
    params = params.with_chroma_subsampling(420)
    with pytest.raises(RuntimeError, match="launch failed"):
        port.Encoder(backend="torch", device="cpu").encode(
            img.reshape(-1), params, image)
