"""E12 (``dct_huffman_blocks``) after its redesign, on the CPU.

* E12's evaluation order, modelled in NumPy: E1's separable float32
  passes (row pass, then column pass, each sum by fused multiply-adds in
  index order from 0, an FMA as its exact float64 product-sum rounded
  once to float32), the bias subtracted last, the IEEE float32 quotient
  by the block's own divisor row, rounding half to even. Held to E1p's
  plain quotients (the dense float32 matmul) and to the plain E12 under
  the per-coefficient tie rule (two float32 evaluations of one quotient
  round apart only where its float64 value lies within ``F32_EVALS``
  bounds of .5), and, followed by the plain walk, to E1p -> plain E2 on
  the scan-order blocks of small plans bit for bit;
* a NumPy model of the warp walk (``csrc/block_walk.cuh`` as E2 and
  ``dct_huffman_blocks.cu`` call it: 32 lanes owning zig-zag 2l and
  2l+1, per-lane chunks from the two ballot masks, the lane scan, the
  register and shared-row placements, fields past the cap counted but
  not placed, ``lookups``' window placement by OR, the ``valid`` and DC
  rules) held bit for bit to ``_walk_plain`` at ``cap_words`` 1, 4, 8 and
  56 on E2's envelope blocks (Annex K and a 16-bit ZRL), random
  quotients, blocks with ``valid == 0`` and the E12 order's quotients of
  ``perf_stage1``'s small inputs; bit for bit to K12's walk
  (``_chunk_planes_packed`` as ``block_chunks_pallas`` runs it) in
  interpret mode on the same cases at caps 4 and 56, and to K12
  (``block_chunks_dct_pallas``) itself on ``perf_stage1``'s inputs
  outside ties;
* the wrapper's check of ``dct``, the ``io`` mode's group of 64 blocks
  on a count that is no multiple of it, and ``tools/perf_e12.py`` on the
  CPU (its cut edits against the source)."""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stage1 import _script_inputs

from gpujpeg_tpu.ops import entropy_v2 as ref_ev2
from gpujpeg_tpu.tables import ZIGZAG_TO_NATURAL as REF_ZIGZAG
from gpujpeg_tpu.tables import dct8_matrix as ref_dct8_matrix
import gpujpeg_tpu_torch as port
from gpujpeg_tpu_torch.ops import dct, entropy
from gpujpeg_tpu_torch.ops.preprocess import (
    plane_geometry, preprocess_planes, upload_raw)
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.tables import (
    build_huffman_table, dct_zigzag_operator, device_tables, encode_tables)
from gpujpeg_tpu_torch import _build
from gpujpeg_tpu_torch.tools import perf_e12, perf_stage1

F32_DOT_REL = 2.0 ** -17
F32_EVALS = 2
#: dct8.cuh's kD8: the 8-point factor in float32
D8 = ref_dct8_matrix().astype(np.float32)


def _fmaf(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)`` of float32 arrays: the product is exact in
    float64, the sum rounded there and then to float32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def e12_order_quotients(blocks, qsel, qdiv, bias) -> np.ndarray:
    """(NB, 64) int32 zig-zag quotients in E12's order (E1's and E1p's):
    ``fdct8_row`` (t[r][u] = sum_k x[r][k] D[u][k]), the column pass
    (y[v][u] = sum_j D[v][j] t[j][u]), each sum by fmaf in index order
    from 0, then at each zig-zag position ``- bias`` in float32, the
    float32 quotient by the block's own divisor row, rint half to
    even."""
    x = np.asarray(blocks, np.float32).reshape(-1, 8, 8)     # [b, r, k]
    t = np.zeros_like(x)                                     # [b, r, u]
    for k in range(8):
        t = _fmaf(x[:, :, k:k + 1], D8[None, None, :, k], t)
    y = np.zeros_like(x)                                     # [b, v, u]
    for j in range(8):
        y = _fmaf(D8[None, :, j, None], t[:, j:j + 1, :], y)
    yz = y.reshape(-1, 64)[:, REF_ZIGZAG] - np.asarray(bias, np.float32)
    q = yz / np.asarray(qdiv, np.float32)[np.asarray(qsel)]
    return np.rint(q).astype(np.int32)


def e12_order(blocks, diff, cls, valid, qsel, qdiv, D, bias, ac, dc, cap):
    """E12 (``full``) in its order: :func:`e12_order_quotients`, then the
    plain walk."""
    q = torch.from_numpy(e12_order_quotients(blocks.numpy(), qsel.numpy(),
                                             qdiv.numpy(), bias.numpy()))
    return entropy._walk_plain(q, diff, cls, valid, ac, dc, cap)


def float64_ties(blocks, qsel, qdiv) -> np.ndarray:
    """(NB, 64) bool: quotients whose float64 value lies within F32_EVALS
    float32 bounds of .5."""
    D64, bias64 = dct_zigzag_operator()
    x = np.asarray(blocks, np.float64)
    q = np.asarray(qdiv, np.float64)[np.asarray(qsel)]
    y = (x @ D64 - bias64) / q
    eps = F32_DOT_REL * (x @ np.abs(D64) + np.abs(bias64)) / q
    return np.abs(np.abs(y - np.floor(y)) - 0.5) <= F32_EVALS * eps


def string_mismatch(a, b, cap) -> np.ndarray:
    """(NB,) bool: blocks whose bits or words (up to their string's end)
    differ."""
    (wa, ba), (wb, bb) = ((np.asarray(w), np.asarray(x)) for w, x in (a, b))
    n = (np.minimum(bb, 32 * cap) + 31) // 32
    used = np.arange(cap)[None, :] < n[:, None]
    return (ba != bb) | ((wa != wb) & used).any(axis=1)


def _tool_args(q=75, h=72):
    inp = perf_stage1.make_inputs(["stage1"], h, 64, quality=q)
    return perf_stage1.e12_args(inp, inp.geo.words_per_block)[:10], \
        inp.geo.words_per_block


@pytest.mark.parametrize("q,h", [(75, 72), (100, 64)])
def test_e12_order_against_e1p_plain_per_coefficient(q, h):
    """On ``perf_stage1``'s inputs the order's quotients differ from E1p's
    plain ones (the dense float32 matmul, which the plain E12 shares) by
    at most 1, and only at float64 ties; the strings of the order differ
    from the plain E12's only in blocks that hold such a quotient."""
    args, W = _tool_args(q, h)
    blocks, qsel, qdiv, bias = args[0], args[4], args[5], args[7]
    mine = e12_order_quotients(blocks.numpy(), qsel.numpy(), qdiv.numpy(),
                               bias.numpy())
    NB = blocks.shape[0]
    blk = torch.tensor([[0, 8, 0, 1]], dtype=torch.int32)
    e1p = np.stack([dct.fdct_quant_planes_plain(
        blocks.reshape(-1), args[6], bias, qdiv[r:r + 1], blk,
        torch.arange(NB, dtype=torch.int32)).numpy()
        for r in range(qdiv.shape[0])])[qsel.numpy(), np.arange(NB)]
    d = np.abs(mine.astype(np.int64) - e1p)
    ties = float64_ties(blocks.numpy(), qsel.numpy(), qdiv.numpy())
    assert d.max() <= 1 and ties[d != 0].all()
    for cap in (W, entropy.BLOCK_CAP_WORDS):
        bad = string_mismatch(e12_order(*args, cap),
                              entropy.dct_huffman_blocks(*args, cap), cap)
        assert ties[bad][:, 1:].any(axis=1).all()
        assert bad.sum() <= (d[:, 1:] != 0).any(axis=1).sum()


@pytest.mark.parametrize("sub,interleaved", [(420, True), (444, False)])
def test_e12_order_equals_e1p_then_e2(sub, interleaved):
    """On the scan-order blocks of E0's planes, E12's order with ``qsel``
    the block's plane, ``diff`` through ``dc_pred`` and every block valid
    at ``cap_words = BLOCK_CAP_WORDS`` equals the same quotients through
    the plain E2, bit for bit, and the quotients are E1p's plain ones
    outside ties."""
    image = port.ImageParameters(width=64, height=48)
    params = port.Parameters(quality=75, restart_interval=2,
                             interleaved=interleaved
                             ).with_chroma_subsampling(sub)
    plan = make_plan(params, image)
    quant_zz, huff = encode_tables(params.quality)
    t = device_tables(quant_zz, huff, "cpu")
    g = plane_geometry(plan, "cpu")
    rng = np.random.default_rng(4)
    planes = preprocess_planes(upload_raw(rng.integers(
        0, 256, 64 * 48 * 3, dtype=np.uint8), image, "cpu"), g)
    blocks, comp = dct.scan_order_blocks(planes, g.blk, g.block_plane_idx)
    qdiv = torch.stack([t.qdiv[c.quant_table_index]
                        for c in plan.components]).contiguous()
    coeff = torch.from_numpy(e12_order_quotients(
        blocks.numpy(), comp.numpy(), qdiv.numpy(), t.bias.numpy()))
    e1p = dct.fdct_quant_planes(planes, t.dct, t.bias, qdiv, g.blk,
                                g.block_plane_idx)
    d = (coeff - e1p).abs().numpy()
    ties = float64_ties(blocks.numpy(), comp.numpy(), qdiv.numpy())
    assert d.max() <= 1 and ties[d != 0].all()
    seg = entropy.build_seg_geometry(plan, "cpu")
    want = entropy.huffman_blocks_plain(coeff, seg.dc_pred, seg.block_cls,
                                        t.ac512, t.dc64)
    dc = coeff[:, 0].long()
    pred = seg.dc_pred.long()
    diff = (dc - torch.where(pred < 0, 0, dc[pred.clamp(min=0)])).int()
    got = e12_order(blocks, diff, seg.block_cls, torch.ones_like(diff),
                    comp.int(), qdiv, t.dct, t.bias, t.ac512, t.dc64,
                    entropy.BLOCK_CAP_WORDS)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---------------------------------------------------------------------------
# The warp walk, emulated
# ---------------------------------------------------------------------------

LANES = 32
#: a warp's shared row (``kRow``) and the caps staged a strip (``kStage``)
ROW_WORDS, STAGE_WORDS = 56, 8


def _highest_bit(x: np.ndarray) -> np.ndarray:
    """Index of the highest set bit of x > 0 (``31 - __clz(x)``)."""
    n = np.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big * s
        x = np.where(big, x >> s, x)
    return n


def _category(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    return np.where(a > 0, _highest_bit(np.maximum(a, 1)) + 1, 0)


def _low(val, n):
    return val & ((np.int64(1) << n) - 1)


def lane_fields(q, dc, k, ac512, dc64, arith):
    """``walk_fields``: per block (rows) and lane (columns) the two
    fields, their ZRL counts, the scan's offsets and the total."""
    q = q.astype(np.int64)
    vx, vy = q[:, 0::2], q[:, 1::2]                      # (NB, 32)
    lane = np.arange(LANES)[None, :]
    w = 1 << np.arange(LANES, dtype=np.int64)
    m_lo = ((vx != 0) * w).sum(1)[:, None]                # the ballots
    m_hi = ((vy != 0) * w).sum(1)[:, None]
    below = (np.int64(1) << lane) - 1
    lo_b, hi_b = m_lo & below, m_hi & below
    prev0 = np.maximum(np.where(lo_b > 0, 2 * _highest_bit(lo_b), 0),
                       np.where(hi_b > 0, 2 * _highest_bit(hi_b) + 1, 0))
    i0 = 2 * lane
    k = k.astype(np.int64)[:, None]
    ac = ac512.astype(np.int64)
    z = ac[k * 256 + 0xF0]
    zl = z & 31
    zcode = _low(z >> 5, zl)
    va = np.where(lane == 0, dc.astype(np.int64)[:, None], vx)
    run_a = i0 - prev0 - 1
    cat_a = _category(va)
    sym_a = ((run_a & 15) << 4) | cat_a
    if arith:
        ea = np.where(lane == 0, cat_a * 3 + k, sym_a * 3 + k)
    else:
        ea = np.where(lane == 0,
                      dc64.astype(np.int64)[k * 32 + np.minimum(cat_a, 15)],
                      ac[k * 256 + sym_a])
    za = np.where((lane != 0) & (vx != 0), run_a >> 4, 0)
    len_a = np.where((lane == 0) | (vx != 0), (ea & 31) + cat_a, 0)
    vb_a = np.where(va < 0, va - 1, va) & ((np.int64(1) << cat_a) - 1)
    fa = ((ea >> 5) << cat_a) | vb_a
    sa = fa if arith else _low(fa, len_a)
    run_c = i0 - np.where((lane == 0) | (vx != 0), i0, prev0)
    cat_c = _category(vy)
    sym_c = ((run_c & 15) << 4) | cat_c
    ec = np.where(vy != 0, sym_c * 3 + k if arith else ac[k * 256 + sym_c],
                  ac[k * 256])
    zc = np.where(vy != 0, run_c >> 4, 0)
    len_c = np.where((vy != 0) | (lane == 31), (ec & 31) + cat_c, 0)
    vb_c = np.where(vy < 0, vy - 1, vy) & ((np.int64(1) << cat_c) - 1)
    fc = ((ec >> 5) << cat_c) | vb_c
    sc = fc if arith else _low(fc, len_c)
    ln = (za + zc) * zl + len_a + len_c
    incl = np.cumsum(ln, axis=1)                          # the lane scan
    off = incl - ln
    off_a = off + za * zl
    return dict(sa=sa, sc=sc, len_a=len_a, len_c=len_c, za=za, zc=zc,
                zl=zl, zcode=zcode, off=off, off_a=off_a,
                off_c=off_a + len_a + zc * zl, total=incl[:, -1])


def _or_row(row, cap, off, val, ln, window):
    """``or_field_row`` / ``or_window_row`` into a Python list of words;
    a field starting at or past the row is not placed."""
    j = off >> 5
    if ln == 0 or j >= cap:
        return
    if window:
        s0 = 32 - (off & 31) - ln
        lo = (val << s0) if s0 >= 0 else val >> min(-s0, 31)
        hi = 0 if s0 >= 0 else val << max(32 + s0, 0)
    else:
        e = (off & 31) + ln
        lo = val << (32 - e) if e <= 32 else val >> (e - 32)
        hi = 0 if e <= 32 else val << (64 - e)
    row[j] |= lo & 0xFFFFFFFF
    if j + 1 < cap:
        row[j + 1] |= hi & 0xFFFFFFFF


def warp_walk(q, diff, cls, valid, ac512, dc64, cap, arith=False):
    """E12's walk (``full``, or ``lookups`` with ``arith``) as the kernel
    runs it, a warp per block: (words (NB, cap) int32, with what a block's
    stores leave (the staged rows of cap <= STAGE_WORDS are zeroed, other
    words stay -1), bits (NB,))."""
    NB = q.shape[0]
    f = lane_fields(q, diff, cls, ac512, dc64, arith)
    words = np.full((NB, cap), -1, np.int64)
    if cap <= STAGE_WORDS:
        words[:] = 0
    bits = np.zeros(NB, np.int64)
    for b in range(NB):
        if not valid[b]:
            continue
        total = int(f["total"][b])
        bits[b] = total
        g = {k: v[b] for k, v in f.items()}
        fields = []
        for lane in range(LANES):
            for j in range(3):
                if j < g["za"][lane]:
                    fields.append((g["off"][lane] + j * g["zl"][0],
                                   g["zcode"][0], g["zl"][0], False))
            fields.append((g["off_a"][lane], g["sa"][lane], g["len_a"][lane],
                           arith))
            for j in range(3):
                if j < g["zc"][lane]:
                    fields.append((g["off_a"][lane] + g["len_a"][lane]
                                   + j * g["zl"][0], g["zcode"][0],
                                   g["zl"][0], False))
            fields.append((g["off_c"][lane], g["sc"][lane], g["len_c"][lane],
                           arith))
        if not arith and total <= 64:      # registers: two words, OR-reduced
            w2 = 0
            for off, val, ln, _ in fields:
                if ln:
                    w2 |= int(val) << (64 - int(off) - int(ln))
            n = min((total + 31) >> 5, cap)
            words[b, :n] = [(w2 >> 32) & 0xFFFFFFFF, w2 & 0xFFFFFFFF][:n]
            continue
        rcap = cap if cap <= STAGE_WORDS else min(cap, ROW_WORDS)
        row = [0] * rcap
        for off, val, ln, window in fields:
            _or_row(row, rcap, int(off), int(val), int(ln), window)
        n = rcap if cap <= STAGE_WORDS else min((total + 31) >> 5, rcap)
        words[b, :n] = row[:n]
    words = np.where(words >= 1 << 31, words - (1 << 32), words)
    return words.astype(np.int32), bits.astype(np.int32)


def _walk_cases():
    """(name, q, diff, cls, valid, tables): E2's envelope blocks with
    random noise and sparse quotients and blocks with ``valid == 0``
    (Annex K, and a 16-bit ZRL), then E12's order's quotients of
    ``perf_stage1``'s small inputs (every string past W = 4 words, padded
    rows invalid) with their tables."""
    rng = np.random.default_rng(12)
    env = entropy.envelope_blocks(rng)
    noise = rng.integers(-300, 300, (40, 64)).astype(np.int32)
    sparse = (rng.integers(-60, 60, (40, 64))
              * (rng.random((40, 64)) < 0.1)).astype(np.int32)
    q = np.concatenate([env, noise, sparse])
    NB = q.shape[0]
    diff = np.concatenate([np.diff(env[:, 0], prepend=0),
                           rng.integers(-400, 400, NB - len(env))]
                          ).astype(np.int32)
    cls = (np.arange(NB) % 3 == 2).astype(np.int32)
    valid = (rng.random(NB) > 0.15).astype(np.int32)
    for zrl16 in (False, True):
        huff = {k: build_huffman_table(*v) for k, v in
                entropy.envelope_huffman_spec(zrl16).items()}
        yield (f"envelope{'-zrl16' if zrl16 else ''}", q, diff, cls, valid,
               entropy.build_packed_tables(huff))
    args, _ = _tool_args()
    blocks, diff, cls, valid, qsel, qdiv, _, bias, ac, dc = (
        a.numpy() for a in args)
    yield ("perf_stage1", e12_order_quotients(blocks, qsel, qdiv, bias),
           diff, cls, valid, types.SimpleNamespace(ac512=ac, dc64=dc))


def _plain_walk(q, diff, cls, valid, t, cap, arith=False):
    return tuple(a.numpy() for a in entropy._walk_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (q, diff, cls, valid, t.ac512, t.dc64)), cap,
        window=arith))


@pytest.mark.parametrize("cap", [1, 4, 8, 56])
@pytest.mark.parametrize("stop", ["full", "lookups"])
def test_warp_walk_model_equals_plain_walk(cap, stop):
    arith = stop == "lookups"
    for name, q, diff, cls, valid, t in _walk_cases():
        got_w, got_b = warp_walk(q, diff, cls, valid, t.ac512, t.dc64, cap,
                                 arith)
        want_w, want_b = _plain_walk(q, diff, cls, valid, t, cap, arith)
        np.testing.assert_array_equal(got_b, want_b, err_msg=name)
        n = (np.minimum(want_b, 32 * cap) + 31) // 32
        used = np.arange(cap)[None, :] < n[:, None]
        np.testing.assert_array_equal(np.where(used, got_w, 0),
                                      np.where(used, want_w, 0),
                                      err_msg=name)
        if cap <= STAGE_WORDS:      # staged rows: zero past the string
            np.testing.assert_array_equal(got_w, want_w, err_msg=name)
        assert (want_b[valid == 0] == 0).all()
        if cap < entropy.BLOCK_CAP_WORDS:   # some strings are cut
            assert (want_b > 32 * cap).any()


def _as_jax_tables(t):
    """The JAX package's PackedTables of the same packed entries (ZRL and
    EOB as (code, length) per class)."""
    ac = np.asarray(t.ac512, np.int32)

    def pair(sym):
        e = ac[np.array([sym, 256 + sym])]
        return np.stack([e >> 5, e & 31], axis=1).astype(np.int32)
    return ref_ev2.PackedTables(ac, np.asarray(t.dc64, np.int32),
                                pair(0xF0), pair(0x00))


@pytest.mark.parametrize("cap", [4, 56])
def test_warp_walk_model_against_k12_walk_interpret(monkeypatch, cap):
    """The walk model against K12's walk in interpret mode: its entropy
    half ``_chunk_planes_packed`` as ``block_chunks_pallas`` runs it on
    given quotients (the envelope cases and the perf_stage1 quotients),
    bits everywhere and words up to each string's end."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")
    for name, q, diff, cls, valid, t in _walk_cases():
        n = q.shape[0] - q.shape[0] % 16
        q, diff, cls, valid = q[:n], diff[:n], cls[:n], valid[:n]
        words, bits = ref_ev2.block_chunks_pallas(
            jnp.asarray(q), jnp.asarray(diff[:, None]), jnp.asarray(cls),
            jnp.asarray(valid), _as_jax_tables(t), cap,
            tile=n * max(cap, 4) // 4)     # one grid step (the kernel
        #                                    divides the tile by W / 4)
        k12 = (np.asarray(words).view(np.int32), np.asarray(bits)[:, 0])
        got = warp_walk(q, diff, cls, valid, t.ac512, t.dc64, cap)
        assert not string_mismatch(got, k12, cap).any(), name


def test_warp_walk_model_against_k12_interpret():
    """K12 (``block_chunks_dct_pallas``) in interpret mode on
    ``perf_stage1``'s small inputs (W = 4), against the walk model of
    E12's order's quotients: blocks differ only where an AC quotient lies
    at a float64 tie."""
    import os
    old = os.environ.get("GPUJPEG_TPU_PALLAS_INTERPRET")
    os.environ["GPUJPEG_TPU_PALLAS_INTERPRET"] = "1"
    try:
        pairs, (D2, bias2, tabs), W = _script_inputs(75, 72)
        words, bits = ref_ev2.block_chunks_dct_pallas(
            *(jnp.asarray(pairs[k]) for k in ("pb2", "diff2", "cls2",
                                              "valid2", "qidx")),
            D2, bias2, pairs["q2tab"], tabs, W, tile=16)
    finally:
        if old is None:
            del os.environ["GPUJPEG_TPU_PALLAS_INTERPRET"]
        else:
            os.environ["GPUJPEG_TPU_PALLAS_INTERPRET"] = old
    k12 = (np.asarray(words).view(np.int32), np.asarray(bits)[:, 0])
    name, q, diff, cls, valid, t = list(_walk_cases())[-1]
    assert name == "perf_stage1"
    got = warp_walk(q, diff, cls, valid, t.ac512, t.dc64, W)
    bad = string_mismatch(got, k12, W)
    args, _ = _tool_args()
    ties = float64_ties(args[0].numpy(), args[4].numpy(), args[5].numpy())
    assert ties[bad][:, 1:].any(axis=1).all()
    assert bad.sum() <= 0.01 * bad.size


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_refuses_another_operator():
    """E12's kernel computes ``dct_zigzag_operator()``'s product and reads
    no ``dct``: the wrapper raises for any other ``dct`` (on the CPU too,
    where the plain version would use it), also after an in-place change
    of one it accepted; a float64 operator of the same values is not
    float32."""
    args, W = _tool_args()
    a = list(args)
    entropy.dct_huffman_blocks(*a, W)
    for bad in (a[6] * 2, a[6] + 1e-6, a[6].t(), torch.zeros_like(a[6])):
        b = list(a)
        b[6] = bad.contiguous()
        with pytest.raises(ValueError, match="dct"):
            entropy.dct_huffman_blocks(*b, W)
    b = list(a)
    b[6] = a[6].double()
    with pytest.raises(ValueError, match="dct"):
        entropy.dct_huffman_blocks(*b, W)
    d = a[6].clone()
    a[6] = d
    entropy.dct_huffman_blocks(*a, W)
    d[0, 0] += 1
    with pytest.raises(ValueError, match="dct"):
        entropy.dct_huffman_blocks(*a, W)


@pytest.mark.parametrize("cap", [4, 9])
def test_io_group_of_64_blocks(cap):
    """``io`` writes, in every word of block b, pixel 0 of block b & ~63
    and that block's diff as bits, on 150 blocks (two whole groups and a
    part)."""
    args, _ = _tool_args()
    a = [t[:150].contiguous() if t.dim() and t.shape[0] == args[0].shape[0]
         else t for t in args]
    words, bits = entropy.dct_huffman_blocks(*a, cap, "io")
    g = np.arange(150) & ~63
    px = a[0].numpy()[g, 0].astype(np.int32)
    np.testing.assert_array_equal(words.numpy(),
                                  np.repeat(px[:, None], cap, axis=1))
    np.testing.assert_array_equal(bits.numpy(), a[1].numpy()[g])
    assert len(set(px.tolist())) == 3


def test_perf_e12_kernel_stage_on_cpu(capsys):
    """The tool's kernel stage on the plain versions at 64x64: (i), (ii)
    beside E1p + E2 and E2, every stop mode."""
    rows = perf_e12.main(["kernel", "--device", "cpu", "--height", "64",
                          "--width", "64", "--reps", "1"])
    names = [r["kernel"] for r in rows]
    assert names[:4] == ["(i) dct_huffman_blocks", "(ii) dct_huffman_blocks",
                         "(ii) fdct_quant_planes + huffman_blocks",
                         "(ii) huffman_blocks"]
    assert names[4:] == [f"(iii) dct_huffman_blocks[{m}]"
                         for m in entropy.STOP_MODES]
    assert all(r["clock"] == "host clock" for r in rows)
    assert "perf_e12 kernel: (i) dct_huffman_blocks" in capsys.readouterr().out


def test_perf_e12_cut_edits_match_the_source():
    """Each cut edit finds its text once in ``dct_huffman_blocks.cu``; the
    cut stage needs the card."""
    with open(os.path.join(_build.CSRC, "dct_huffman_blocks.cu")) as f:
        src = f.read()
    for name, old, _ in perf_e12.CUT_EDITS:
        assert src.count(old) == 1, name
    assert {n for n, _, _ in perf_e12.CUT_EDITS} == {
        "no_loads", "no_place", "no_walk"}
    with pytest.raises(RuntimeError, match="card"):
        perf_e12.run(("cut",), "cpu", 16, 16)
