"""The port's stage-1 probes against the JAX package: plain E12
(``dct_huffman_blocks``) against K12 ``block_chunks_dct_pallas`` in
interpret mode on ``scripts/perf_stage1.py``'s inputs, plain E12 against
plain E2, the copied uniform geometry, plain E0 against the word pack of
``scripts/perf_rgbpack.py`` (``rgbpack.pack_plane_words`` and its Pallas
``pk`` in interpret mode), E12's stop modes against the ablation kernel
of ``scripts/ablate_stage1.py`` in interpret mode and against a scalar
walk, ``copy_bytes`` and the three tools on the CPU."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.ops import entropy_v2 as ref_ev2
from gpujpeg_tpu.ops import rgbpack as ref_rgbpack
from gpujpeg_tpu.plan import make_plan as ref_make_plan
from gpujpeg_tpu.tables import dct_zigzag_operator
from gpujpeg_tpu_torch.ops import dct, entropy
from gpujpeg_tpu_torch.ops.preprocess import (
    plane_geometry, preprocess_planes, upload_raw)
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.tables import device_tables, encode_tables
from gpujpeg_tpu_torch.tools import ablate_stage1, perf_rgbpack, perf_stage1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rgb_params(mod, w, h, q, ri=32, interleaved=False, sub=444):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012)
    params = mod.Parameters(quality=q, restart_interval=ri,
                            interleaved=interleaved
                            ).with_chroma_subsampling(sub)
    return params, image


def _script_inputs(q, h, w=64):
    """``scripts/perf_stage1.py``'s stage-1 inputs (lines 46-122), built
    with the JAX package: (pair-row arrays, tables, W)."""
    params, image = _rgb_params(ref, w, h, q)
    plan = ref_make_plan(params, image)
    quant_zz, huff = ref.Encoder(backend="jax")._tables(params)
    tabs = ref_ev2.build_packed_tables(huff)
    probe = ref_ev2.build_uniform_geometry(plan)
    budget = ref_ev2.seg_budget_for_quality(q, probe.bps)
    geo = ref_ev2.build_uniform_geometry(
        plan, cap_bytes_per_block=ref_ev2.block_byte_budget(q),
        seg_byte_budget=min(budget, probe.cap_seg_words * 4))
    N = geo.n_rows
    rng = np.random.default_rng(0)
    coeff = (rng.integers(-40, 40, (N, 64)) *
             (rng.random((N, 64)) < 0.15)).astype(np.int32)
    coeff[:, 0] = rng.integers(-200, 200, N)
    D64, bias64 = dct_zigzag_operator()
    qdiv = np.ones((2, 64), np.float32)
    for qi in range(2):
        qdiv[qi] = np.maximum(np.asarray(quant_zz[qi], np.float32), 1.0)
    D2 = np.zeros((128, 128), np.float32)
    D2[:64, :64] = D64
    D2[64:, 64:] = D64
    bias2 = np.concatenate([bias64, bias64]).astype(np.float32)
    q2tab = np.stack([np.concatenate([qdiv[i], qdiv[j]])
                      for i in range(2) for j in range(2)]).astype(np.float32)
    cls_h = np.asarray(geo.block_cls).reshape(-1, 2)
    pairs = {"pb2": rng.integers(0, 255, (N // 2, 128)).astype(np.uint8),
             "diff2": coeff[:, 0].reshape(-1, 2), "cls2": cls_h,
             "valid2": np.asarray(geo.block_valid).reshape(-1, 2),
             "qidx": (cls_h[:, 0] * 2 + cls_h[:, 1])[:, None],
             "q2tab": q2tab}
    return pairs, (D2, bias2, tabs), geo.words_per_block


def _tie_blocks(blocks, qsel, qdiv) -> np.ndarray:
    """(NB,) bool: blocks with an AC quotient at a float32 .5 tie (its
    float64 value within ``2**-17 * (x @ |D| + |b|) / q`` of .5)."""
    D64, bias64 = dct_zigzag_operator()
    x = np.asarray(blocks, np.float64)
    q = np.asarray(qdiv, np.float64)[np.asarray(qsel)]
    y = (x @ D64 - bias64) / q
    eps = 2.0 ** -17 * (x @ np.abs(D64) + np.abs(bias64)) / q
    return (np.abs(np.abs(y - np.floor(y)) - 0.5) <= eps)[:, 1:].any(axis=1)


@pytest.mark.parametrize("q,W,h", [(75, 4, 72), (100, 56, 64)])
def test_plain_e12_matches_k12_interpret(monkeypatch, q, W, h):
    """K12 run in interpret mode equals its XLA form, and plain E12 on
    K12's operands (``from_pair_rows``) equals K12: bits everywhere,
    words up to the string's end (cut at 32 W bits). At Q75 every random block overflows W = 4 words, and the
    72-row frame's short last segments pad the rows with invalid
    blocks."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    calls = []

    def counted(*a, _orig=ref_ev2._pcall, **kw):
        calls.append(kw.get("grid"))
        return _orig(*a, **kw)
    monkeypatch.setattr(ref_ev2, "_pcall", counted)
    pairs, (D2, bias2, tabs), Wg = _script_inputs(q, h)
    assert Wg == W
    words, bits = ref_ev2.block_chunks_dct_pallas(
        *(jnp.asarray(pairs[k]) for k in ("pb2", "diff2", "cls2", "valid2",
                                          "qidx")),
        D2, bias2, pairs["q2tab"], tabs, W, tile=16)
    assert len(calls) == 1 and calls[0] == (pairs["pb2"].shape[0] // 8,)
    words = np.asarray(words).view(np.int32)
    bits = np.asarray(bits)[:, 0]

    # K12 against its own XLA form: the f32 DCT, then block_chunks_xla
    y = jax.lax.dot_general(
        jnp.asarray(pairs["pb2"], jnp.float32), jnp.asarray(D2),
        (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST) - bias2
    rows = jnp.rint(y / jnp.asarray(pairs["q2tab"])[pairs["qidx"][:, 0]])
    xw, xb = ref_ev2.block_chunks_xla(
        rows.astype(jnp.int32).reshape(-1, 64),
        jnp.asarray(pairs["diff2"].reshape(-1, 1)),
        jnp.asarray(pairs["cls2"].reshape(-1)),
        jnp.asarray(pairs["valid2"].reshape(-1)), tabs, W)
    np.testing.assert_array_equal(np.asarray(xw).view(np.int32), words)
    np.testing.assert_array_equal(np.asarray(xb)[:, 0], bits)

    # the port's tool draws the same arrays
    inp = perf_stage1.make_inputs(["stage1"], h, 64, quality=q)
    for k, v in pairs.items():
        np.testing.assert_array_equal(inp.pairs[k], v, err_msg=k)
    got_w, got_b = entropy.dct_huffman_blocks(
        *perf_stage1.e12_args(inp, W))
    got_w, got_b = got_w.numpy(), got_b.numpy()
    n = (np.minimum(bits, 32 * W) + 31) // 32
    used = np.arange(W)[None, :] < n[:, None]
    bad = (got_b != bits) | ((got_w != words) & used).any(axis=1)
    valid = pairs["valid2"].reshape(-1) == 1
    assert (bits[~valid] == 0).all() and (~valid).any() == (h == 72)
    if q == 75:
        assert (bits[valid] > 32 * W).all()
    e = inp.e12
    ties = _tie_blocks(e["blocks"].numpy(), e["qsel"].numpy(),
                       e["qdiv"].numpy())
    assert bad.sum() <= 1 and ties[bad].all(), np.nonzero(bad)


@pytest.mark.parametrize("interleaved,sub", [(False, 444), (True, 420)])
def test_plain_e12_equals_plain_e2(interleaved, sub):
    """Plain E12 with ``cap_words = BLOCK_CAP_WORDS``, every block valid
    and ``diff`` through ``dc_pred`` equals plain E2 on the same
    quotients, bit for bit (real content, both scan orders)."""
    params, image = _rgb_params(port, 64, 48, 85, 2, interleaved, sub)
    plan = make_plan(params, image)
    quant_zz, huff = encode_tables(params.quality)
    t = device_tables(quant_zz, huff, "cpu")
    g = plane_geometry(plan, "cpu")
    img = make_test_rgb(48, 64)
    planes = preprocess_planes(upload_raw(img, image, "cpu"), g)
    blocks, comp = dct.scan_order_blocks(planes, g.blk, g.block_plane_idx)
    assert np.array_equal(comp.numpy(), plan.block_comp)
    comp = comp.to(torch.int32)
    qdiv = torch.stack([t.qdiv[c.quant_table_index]
                        for c in plan.components]).contiguous()
    seg = entropy.build_seg_geometry(plan, "cpu")
    q = dct.fdct_quant_planes_plain(planes, t.dct, t.bias, qdiv, g.blk,
                                    g.block_plane_idx)
    dc = q[:, 0].long()
    pred = seg.dc_pred.long()
    diff = (dc - torch.where(pred < 0, 0, dc[pred.clamp(min=0)])).int()
    w12, b12 = entropy.dct_huffman_blocks(
        blocks, diff, seg.block_cls, torch.ones_like(diff), comp, qdiv,
        t.dct, t.bias, t.ac512, t.dc64, entropy.BLOCK_CAP_WORDS)
    w2, b2 = entropy.huffman_blocks(q, seg.dc_pred, seg.block_cls, t.ac512,
                                    t.dc64)
    assert torch.equal(b12, b2) and torch.equal(w12, w2)
    assert int(b2.min()) > 0


@pytest.mark.parametrize("q,interleaved,sub", [
    (75, False, 444), (90, True, 444), (100, False, 444), (75, True, 420)])
def test_uniform_geometry_matches_reference(q, interleaved, sub):
    """The tools' copy of ``build_uniform_geometry``,
    ``block_byte_budget`` and ``seg_budget_for_quality`` equals the JAX
    package's, default and tier-1 (the probe scripts' sizing), on the
    fields the tools read."""
    w, h = 136, 72
    pp, pi = _rgb_params(port, w, h, q, 4, interleaved, sub)
    rp, ri = _rgb_params(ref, w, h, q, 4, interleaved, sub)
    plan, rplan = make_plan(pp, pi), ref_make_plan(rp, ri)
    for bps in (1, 4, 32):
        assert perf_stage1.seg_budget_for_quality(q, bps) == \
            ref_ev2.seg_budget_for_quality(q, bps)
    assert perf_stage1.block_byte_budget(q) == ref_ev2.block_byte_budget(q)
    probe = perf_stage1.build_uniform_geometry(plan)
    kw = {"cap_bytes_per_block": perf_stage1.block_byte_budget(q),
          "seg_byte_budget": perf_stage1.seg_budget_for_quality(q, probe.bps)}
    for args in ({}, kw):
        a = perf_stage1.build_uniform_geometry(plan, **args)
        b = ref_ev2.build_uniform_geometry(rplan, **args)
        for f in ("bps", "n_rows", "coeff_idx", "block_cls", "block_valid",
                  "words_per_block", "cap_seg_words"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    assert a.n_rows > plan.n_blocks


def _plain_e0_words(img: np.ndarray) -> np.ndarray:
    H, W, _ = img.shape
    plan = perf_stage1.stage1_plan(H, W)[0]
    g = plane_geometry(plan, "cpu")
    planes = preprocess_planes(upload_raw(img.reshape(-1), plan.image, "cpu"),
                               g)
    return perf_rgbpack.plane_words(planes, H, W).numpy()


def test_plain_e0_equals_pack_plane_words():
    """Plain E0 for RGB 4:4:4, read as int32 words, equals the JAX
    ``rgbpack.pack_plane_words`` of the raw words."""
    img = perf_rgbpack.make_frame(24, 64)
    rp, ri = _rgb_params(ref, 64, 24, 75)
    m9, base = ref_rgbpack.pack_consts(ref_make_plan(rp, ri))
    raw_w = ref_rgbpack.host_raw_words(img.reshape(-1), 24, 64)
    want = np.asarray(ref_rgbpack.pack_plane_words(jnp.asarray(raw_w), m9,
                                                   base))
    np.testing.assert_array_equal(_plain_e0_words(img), want)


def test_plain_e0_equals_perf_rgbpack_pk_interpret(monkeypatch):
    """Plain E0 equals ``scripts/perf_rgbpack.py``'s Pallas ``pk`` run in
    interpret mode on a body that calls ``_shuffle_transform`` as its
    ``body_slice`` does (frame size set before the import)."""
    H, W = 16, 64
    monkeypatch.setenv("PACK_H", str(H))
    monkeypatch.setenv("PACK_W", str(W))
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    spec = importlib.util.spec_from_file_location(
        "perf_rgbpack_script", os.path.join(REPO, "scripts", "perf_rgbpack.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def counted(*a, _orig=mod._pcall, **kw):
        calls.append(kw.get("grid"))
        return _orig(*a, **kw)
    monkeypatch.setattr(mod, "_pcall", counted)
    rp, ri = _rgb_params(ref, W, H, 75)
    m9, base = mod.pack_consts(ref_make_plan(rp, ri))

    def body_slice(raw_ref, out_ref):
        w = raw_ref[:]
        y, cb, cr = mod._shuffle_transform(w[:, 0::3], w[:, 1::3],
                                           w[:, 2::3], m9, base)
        out_ref[0], out_ref[1], out_ref[2] = y, cb, cr

    img = perf_rgbpack.make_frame(H, W)
    raw_w = jnp.asarray(img.reshape(H, 3 * W // 4, 4).view("<i4")[..., 0])
    want = np.asarray(mod.pk(body_slice, 8)(raw_w))
    assert calls == [(H // 8,)]
    np.testing.assert_array_equal(_plain_e0_words(img), want)


def _ablate_script():
    """``scripts/ablate_stage1.py`` as a module (unedited)."""
    spec = importlib.util.spec_from_file_location(
        "ablate_stage1_script",
        os.path.join(REPO, "scripts", "ablate_stage1.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _ablate_inputs():
    """The script's ``main`` inputs at 72x64 Q75 (its lines 278-319, with
    the JAX package), padded to its tile of 768 blocks: (pair-row arrays,
    script tables, W)."""
    pairs, (D2, bias2, tabs), W = _script_inputs(75, 72)
    M = pairs["pb2"].shape[0]
    Mp = -(-M // 384) * 384
    rng = np.random.default_rng(0)
    pb2 = rng.integers(0, 255, (Mp, 128)).astype(np.uint8)
    diff2 = rng.integers(-200, 200, (Mp, 2)).astype(np.int32)
    cls2 = np.zeros((Mp, 2), np.int32)
    cls2[:M] = pairs["cls2"]
    valid2 = np.zeros((Mp, 2), np.int32)
    valid2[:M] = pairs["valid2"]
    qidx = (cls2[:, 0] * 2 + cls2[:, 1])[:, None]
    return ((pb2, diff2, cls2, valid2, qidx), (tabs, D2, bias2,
                                               pairs["q2tab"]), W)


@pytest.mark.parametrize("stop", entropy.STOP_MODES)
def test_stop_modes_plain_match_ablate_script(monkeypatch, stop):
    """Each stop mode's plain version, on the port tool's inputs, equals
    the script's ``build(stop, ...)`` kernel run in interpret mode on the
    same arrays (a tile of 64 blocks, ``io``'s group, for ``io``): words the
    string fills (all words outside ``lookups``/``full``) and bits, in
    every block. The tool draws the script's arrays."""
    from jax.experimental import pallas as pl
    calls = []

    def interpret(*a, _orig=pl.pallas_call, **kw):
        calls.append(kw.get("grid"))
        return _orig(*a, **{**kw, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", interpret)
    arrays, (tabs, D2, bias2, q2tab), W = _ablate_inputs()
    args, W_tool = ablate_stage1.make_inputs(72, 64, "cpu")
    want = entropy.from_pair_rows(*arrays, q2tab)
    for k, t in zip(("blocks", "diff", "block_cls", "valid", "qsel", "qdiv"),
                    args):
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    assert W == W_tool == 4
    run = _ablate_script().build(stop, 64, tabs, W, 2, D2, bias2, q2tab)
    sw, sb = run(*(jnp.asarray(a) for a in arrays))
    assert calls == [(arrays[0].shape[0] // 32,)]
    sw = np.asarray(sw).view(np.int32).reshape(-1, W)
    sb = np.asarray(sb).reshape(-1)
    pw, pb = (t.numpy() for t in entropy.dct_huffman_blocks(*args, W, stop))
    np.testing.assert_array_equal(pb, sb)
    if stop in ("lookups", "full"):
        n = (np.minimum(sb, 32 * W) + 31) // 32
        used = np.arange(W)[None, :] < n[:, None]
        assert (sb > 32 * W).any() and (sb[args[3].numpy() == 1] > 0).all()
    else:
        used = np.ones_like(sw, bool)
    np.testing.assert_array_equal(np.where(used, pw, 0), np.where(used, sw, 0))


def _fields(q, dv, cls, entry_ac, entry_dc):
    """One block's fields (value, length) by a scalar walk (T.81 F.1.2)."""
    out = []

    def put(e, v, cat):
        code, n = int(e) >> 5, int(e) & 31
        vb = (v if v >= 0 else v + (1 << cat) - 1) & ((1 << cat) - 1)
        out.append(((code << cat) | vb, n + cat))

    cat = abs(int(dv)).bit_length()
    put(entry_dc(cls, cat), int(dv), cat)
    run = 0
    for j in range(1, 64):
        v = int(q[j])
        if v == 0:
            run += 1
            continue
        while run > 15:
            put(entry_ac(cls, 0xF0, True), 0, 0)
            run -= 16
        cat = abs(v).bit_length()
        put(entry_ac(cls, (run << 4) | cat), v, cat)
        run = 0
    if run:
        put(entry_ac(cls, 0, True), 0, 0)
    return out


def _bit_string(fields, cap_words):
    """Fields cut to their lengths, MSB first: (first cap_words words as
    int32, full bit length)."""
    bits = [(v >> (n - 1 - i)) & 1 for v, n in fields for i in range(n)]
    n = len(bits)
    bits += [0] * (-n % 32)
    words = [int("".join(map(str, bits[32 * k:32 * k + 32])), 2)
             for k in range(min(cap_words, len(bits) // 32))]
    return np.array(words, np.uint32).view(np.int32), n


def _window_string(fields, cap_words):
    """Fields placed by K12's window formula (shifts clipped, nothing
    cut), words past ``cap_words`` dropped: (words, bit length)."""
    words = [0] * (cap_words + 1)
    off = 0
    for v, n in fields:
        if n:
            j, s0 = off >> 5, 32 - (off & 31) - n
            lo = (v << s0) if s0 >= 0 else v >> min(-s0, 31)
            hi = 0 if s0 >= 0 else v << max(32 + s0, 0)
            for k, part in ((j, lo), (j + 1, hi)):
                if k < cap_words:
                    words[k] |= part & 0xFFFFFFFF
        off += n
    used = min(cap_words, -(-off // 32))
    return np.array(words[:used], np.uint32).view(np.int32), off


@pytest.mark.parametrize("stop", entropy.STOP_MODES)
def test_stop_modes_plain_on_a_few_blocks(stop):
    """Each stop mode's plain version against the function its source
    documents, block by block (flat, random, invalid and smooth blocks;
    W = 4 cuts the long strings)."""
    rng = np.random.default_rng(5)
    params = port.Parameters(quality=75, restart_interval=32)
    quant_zz, huff = encode_tables(params.quality)
    t = device_tables(quant_zz, huff, "cpu")
    yy, xx = np.mgrid[0:8, 0:8]
    blocks = np.stack([np.full(64, 128), rng.integers(0, 256, 64),
                       (100 + 9 * xx + 2 * yy).reshape(-1),
                       rng.integers(0, 256, 64),
                       (60 + 4 * xx * yy).reshape(-1),
                       np.where(xx + yy == 7, 255, 0).reshape(-1)]
                      ).astype(np.uint8)
    NB, W = blocks.shape[0], 4
    diff = np.array([0, -300, 17, 5, -1, 1024], np.int32)
    cls = np.array([0, 1, 0, 1, 1, 0], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1], np.int32)
    qsel = np.array([0, 1, 0, 1, 1, 0], np.int32)
    args = [torch.from_numpy(a) for a in (blocks, diff, cls, valid, qsel)]
    words, bits = entropy.dct_huffman_blocks(
        *args, t.qdiv, t.dct, t.bias, t.ac512, t.dc64, W, stop)
    words, bits = words.numpy(), bits.numpy()
    y = dct.fdct_blocks_plain(args[0], t.dct, t.bias)
    qd = t.qdiv[args[4].long()]
    q = dct.quantize_plain(y, qd).numpy().astype(np.int64)
    v = np.concatenate([diff[:, None], q[:, 1:]], axis=1)
    cat = np.vectorize(lambda x: abs(int(x)).bit_length())(v)
    pair = {"passthru": (blocks.astype(np.int64),) * 2,
            "dctonly": (y.to(torch.int64).numpy(),) * 2,
            "dct": (q, q),
            "dctmul": (torch.round(y * qd).to(torch.int64).numpy(),) * 2,
            "synth": ((np.where(v >= 0, v, v + (1 << cat) - 1)
                       & ((1 << cat) - 1)) + cat, cat)}
    ac = t.ac512.numpy()
    dc = t.dc64.numpy()
    tables = {"full": (lambda k, s, z=False: int(ac[k * 256 + s]),
                       lambda k, c: int(dc[k * 32 + min(c, 15)])),
              "lookups": (lambda k, s, z=False: int(ac[k * 256 + s]) if z
                          else s * 3 + k, lambda k, c: c * 3 + k)}
    for b in range(NB):
        e, h = b & ~1, b & 1
        if stop == "io":
            assert (words[b] == blocks[0, 0]).all() and bits[b] == diff[0]
        elif stop in pair:
            vals, bvals = pair[stop]
            want = [vals[e, h * W + w] if h * W + w < 8 else 0
                    for w in range(W)]
            assert list(words[b]) == want and bits[b] == bvals[e, h]
        elif not valid[b]:
            assert bits[b] == 0
        else:
            fields = _fields(q[b], diff[b], cls[b], *tables[stop])
            string = _window_string if stop == "lookups" else _bit_string
            want_w, want_b = string(fields, W)
            assert bits[b] == want_b
            np.testing.assert_array_equal(words[b, :len(want_w)], want_w)
            assert (words[b, len(want_w):] == 0).all()
    if stop in ("lookups", "full"):
        assert (bits > 32 * W).any() and (bits[valid == 1] < 32 * W).any()


def test_from_pair_rows_layout():
    """Block 2i takes the left half of its pair row's divisors, block
    2i+1 the right half."""
    rng = np.random.default_rng(2)
    q2tab = rng.random((4, 128)).astype(np.float32) + 1
    qidx = np.array([[3], [0], [2]])
    e = entropy.from_pair_rows(
        rng.integers(0, 256, (3, 128)).astype(np.uint8),
        np.arange(6).reshape(3, 2), np.zeros((3, 2)), np.ones((3, 2)), qidx,
        q2tab)
    rows = e["qdiv"][e["qsel"]].reshape(3, 128)
    np.testing.assert_array_equal(rows, q2tab[qidx[:, 0]])
    assert e["blocks"].shape == (6, 64) and list(e["diff"]) == list(range(6))


def test_copy_bytes_plain_and_wrapper_checks():
    x = torch.arange(1000, dtype=torch.int32).view(10, 100)
    y = perf_stage1.copy_bytes(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(perf_stage1.copy_bytes_plain(x), x)
    with pytest.raises(ValueError, match="contiguous"):
        perf_stage1.copy_bytes(x.t())
    with pytest.raises(ValueError, match="unsupported device"):
        perf_stage1.copy_bytes(torch.empty(8, device="meta"))
    assert perf_stage1.copy_grid(99532800) == (12150, 256)
    assert perf_stage1.copy_grid(8192) == (1, 256)
    assert perf_stage1.copy_grid(8193) == (2, 256)
    assert perf_stage1.copy_grid(0) == (0, 256)
    with pytest.raises(ValueError, match="stop"):
        entropy.dct_huffman_blocks(*(torch.zeros(0),) * 10, 4, "windows")


@pytest.mark.parametrize("tool", [perf_stage1, ablate_stage1, perf_rgbpack],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_main_on_cpu(tool, capsys):
    rows = tool.main(["--device", "cpu", "--height", "64", "--width", "64",
                      "--reps", "1"])
    stages = {perf_stage1: perf_stage1.STAGES,
              ablate_stage1: entropy.STOP_MODES,
              perf_rgbpack: perf_rgbpack.STAGES}[tool]
    assert [r["stage"] for r in rows] == list(stages)
    assert all(r["clock"] == "host clock" and r["ms"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "on cpu" in out and "TB_per_s" not in out
    with pytest.raises(SystemExit):
        tool.main(["nonesuch", "--device", "cpu"])
