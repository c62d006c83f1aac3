"""The port's entropy stage (plain E2 + E3 on the CPU) against the JAX
package's Pallas entropy kernels K6-K11 in interpret mode, bit for bit,
on the JAX package's own coefficients, over the geometries that reach
each kernel: interleaved MCU order with 3 and 6 blocks per MCU, short
last segments, one component, and the fused stage 1 (K6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import entropy_v2 as ref_ev2
from gpujpeg_tpu.ops import jax_pipeline as ref_jp
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu_torch.ops.pipeline import EncContext
from gpujpeg_tpu_torch.plan import make_plan

#: the JAX package's entropy kernels, by the names of the port's records
KERNELS = {"K6": "block_chunks_dct_fused", "K7": "block_chunks_pallas",
           "K8": "merge_stuff_packed", "K9": "merge_segments_packed",
           "K10": "merge_segments_pallas", "K11": "stuff_and_rst_pallas"}

PF = port.PixelFormat
#: (name, height, width, pixel format, quality, restart interval,
#: interleaved, sampling, the JAX route, the kernels it reaches on the
#: staged coefficients, the kernels of its fused route); the three staged
#: geometries end their scan on a short segment (108 MCUs in segments of
#: 8, 15 MCUs in segments of 2, 77 blocks in segments of 4)
GEOMETRIES = [
    ("interleaved 4:4:4 Q75 ri=8 (bps 32, W 4)", 72, 96, PF.PF_444_U8_P012,
     75, 8, True, 444, "staged", {"K7", "K8"}, None),
    ("interleaved 4:2:0 Q75 ri=2 (bps 16, W 4)", 48, 80, PF.PF_444_U8_P012,
     75, 2, True, 420, "staged", {"K7", "K9", "K11"}, None),
    ("grayscale Q100 ri=4 (bps 4, W 56)", 56, 88, PF.U8, 100, 4, True, 444,
     "staged", {"K7", "K10", "K11"}, None),
    ("non-interleaved RGB Q75 ri=4 (fused, W 4)", 64, 80, PF.PF_444_U8_P012,
     75, 4, False, 444, "fused", {"K7", "K9", "K11"}, {"K6", "K9", "K11"}),
    ("non-interleaved RGB Q100 ri=4 (fused, W 56)", 64, 80,
     PF.PF_444_U8_P012, 100, 4, False, 444, "fused", {"K7", "K10", "K11"},
     {"K6", "K10", "K11"}),
]


def test_geometries_reach_every_entropy_kernel():
    reached = set()
    for g in GEOMETRIES:
        reached |= g[-2] | (g[-1] or set())
    assert reached == set(KERNELS)


def _segments(out, out_len, seg_bits, n_ff, S, cap):
    """Per-segment (bytes, out_len, seg_bits, n_ff) of the first ``S``
    segments of an (out, out_len, seg_bits, n_ff) entropy result."""
    by = np.asarray(out).reshape(-1).view(np.uint8).reshape(-1, cap)
    ol, sb, nf = (np.asarray(a)[:S] for a in (out_len, seg_bits, n_ff))
    return [(by[s, :ol[s]].tobytes(), int(ol[s]), int(sb[s]), int(nf[s]))
            for s in range(S)]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                      GEOMETRIES])
def test_plain_e2_e3_match_pallas_entropy_kernels(monkeypatch, geometry):
    (_, h, w, pf, q, ri, interleaved, sub, kind, staged_kernels,
     fused_kernels) = geometry
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    reached = set()
    for k, name in KERNELS.items():
        def counted(*a, _orig=getattr(ref_ev2, name), _k=k, **kw):
            reached.add(_k)          # at trace time
            return _orig(*a, **kw)
        monkeypatch.setattr(ref_ev2, name, counted)
    ref_jp._ENC_CACHE.clear()

    img = make_test_rgb(h, w)
    raw = img[:, :, 0].reshape(-1) if pf == PF.U8 else img.reshape(-1)
    rimage = ref.ImageParameters(width=w, height=h,
                                 color_space=ref.ColorSpace.RGB,
                                 pixel_format=ref.PixelFormat(int(pf)))
    rparams = ref.Parameters(quality=q, restart_interval=ri,
                             interleaved=interleaved
                             ).with_chroma_subsampling(sub)
    rplan = ref_make_plan(rparams, rimage)
    quant_zz, huff = ref.Encoder(backend="jax")._tables(rparams)
    try:
        rctx = ref_jp._enc_context(rplan, quant_zz, huff)
        assert rctx.fn.kind == kind
        S, cap = rplan.n_segments, rctx.cap_out_bytes
        s_pre, s_dct, s_ent = rctx._stage_fns
        rows = s_dct(s_pre(jnp.asarray(raw)), *rctx._stage_args[0])
        res = s_ent(rows, *rctx._stage_args[1])
        assert not ref_jp._seg_overflow(rctx, rplan, np.asarray(res[1]),
                                        res[2], res[3])
        assert reached == staged_kernels
        expect = {"staged": _segments(*res, S, cap)}
        if fused_kernels is not None:
            reached.clear()
            res = rctx.fn(jnp.asarray(raw))
            assert reached == fused_kernels
            expect["fused"] = _segments(*res, S, cap)
    finally:
        ref_jp._ENC_CACHE.clear()

    # the JAX coefficients in scan order, through the port's E2 + E3
    rows = np.asarray(rows)
    real = rctx.geo.coeff_idx < rplan.n_blocks
    coeff = np.zeros((rplan.n_blocks, 64), np.int32)
    coeff[rctx.geo.coeff_idx[real]] = rows[real]
    image = port.ImageParameters(width=w, height=h,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=pf)
    params = port.Parameters(quality=q, restart_interval=ri,
                             interleaved=interleaved
                             ).with_chroma_subsampling(sub)
    ctx = EncContext(make_plan(params, image), quant_zz, huff,
                      torch.device("cpu"))
    out, out_len, seg_bits, n_ff = ctx.entropy(torch.from_numpy(coeff))
    got = _segments(out.numpy(), out_len, seg_bits, n_ff, S,
                    ctx.geo.cap_out)
    assert all(n > 0 for _, n, _, _ in got)
    if kind == "staged":
        assert rplan.seg_block_count[-1] < rplan.seg_block_count[0]
    for route, want in expect.items():
        assert got == want, route
