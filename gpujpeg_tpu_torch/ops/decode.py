"""Segment-parallel Huffman decode of the device decode: host prep and D1.

Counterpart of the JAX reference's ``gpujpeg_tpu/ops/pallas_decode.py``
(host half) and of its three Huffman decoders. The host destuffs every
restart segment into a row of big-endian u32 words
(:func:`build_segment_rows_from_ranges`, the native ``gj_build_rows``);
the decode tables (:func:`build_dec_tables_v2`) and the DC-first table
slots (:func:`table_slots`) are the reference's, bit for bit.

**D1** :func:`huffman_decode` (``csrc/huffman_decode.cu``) decodes the
rows to zig-zag coefficients in scan order, one thread per segment, for
any plan: any block -> component map (interleaved MCUs of 3 to 10
blocks, 1 to 4 components) and any row width. It is the counterpart of
the Huffman half of ``pallas_decode_v3.make_decode_kernel_v3`` (K2), of
its coefficient form ``run_raw`` (K4, rows of at most ``V3_WCAP_MAX`` =
384 words) and of the v2 decoder ``pallas_decode.make_decode_kernel``
(K5, longer rows). Its plain torch version :func:`huffman_decode_plain`
decodes all segments in lockstep, one symbol per step; it also stands
for the reference's XLA v1 decoder (``huffman_decode.py:93``, its form
on a backend without Pallas). The wrapper takes the plain version only
for tensors on the CPU.

Both follow K2 where it differs from the golden decoder on a corrupt
stream: reads past a row see zero words, an invalid code gives symbol 0
and consumes one bit, and a position past 63 writes nothing and ends
the block *after* consuming that symbol's value bits (golden stops
before them). The TPU-only parts of the reference (seg_tile sizing, the
v2/v3 route at ``V3_WCAP_MAX``, ``bucket_wcap``, the transposed rows,
the interleaved slot template) have no counterpart: the row width
``wcap`` is a runtime argument, and zero words past a segment's data
are harmless.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..tables import HuffmanTable
from .entropy import _check as check_operands

#: lookahead bits of the quick table (the reference's value, kept so the
#: tables carry across bit for bit)
QUICK_BITS = 8
#: JPEG allows at most four Huffman table slots per scan set
MAX_SLOTS = 4


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecTables:
    """Up to 4 table slots: 2*dc_table_idx + 0, 2*ac_table_idx + 1 order —
    slot = comp's (kind, index) resolved by the caller."""

    quick: np.ndarray     # (n_slots, 256) int32: sym<<5 | len (len 0 = slow)
    maxcode: np.ndarray   # (n_slots, 18) int32 (code < maxcode[l] test), l=1..17
    delta: np.ndarray     # (n_slots, 17) int32: valptr[l] - mincode[l]
    huffval: np.ndarray   # (n_slots, 256) int32


def build_dec_tables_v2(tables: list[HuffmanTable]) -> DecTables:
    n = len(tables)
    quick = np.zeros((n, 1 << QUICK_BITS), np.int32)
    maxcode = np.zeros((n, 18), np.int32)
    delta = np.zeros((n, 17), np.int32)
    huffval = np.zeros((n, 256), np.int32)
    for t, tab in enumerate(tables):
        nv = min(len(tab.values), 256)
        huffval[t, :nv] = tab.values[:nv]
        # canonical code enumeration (T.81 C.2)
        code = 0
        k = 0
        mincode = np.zeros(17, np.int64)
        valptr = np.zeros(17, np.int64)
        for l in range(1, 17):
            valptr[l] = k
            mincode[l] = code
            nl = int(tab.bits[l - 1])
            for _ in range(nl):
                if l <= QUICK_BITS:
                    lo = code << (QUICK_BITS - l)
                    hi = (code + 1) << (QUICK_BITS - l)
                    quick[t, lo:hi] = (int(tab.values[k]) << 5) | l
                k += 1
                code += 1
            maxcode[t, l] = code << (16 - l)  # compare against 16-bit peek
            code <<= 1
        maxcode[t, 17] = 1 << 30              # terminator (gpujpeg_table.c:423)
        delta[t, :] = (valptr - mincode)[:17]
    return DecTables(quick, maxcode, delta, huffval)


def table_slots(plan, dc_by_comp, ac_by_comp):
    """Unique Huffman tables, DC tables first, and the (4,) int32
    component -> slot maps ``dc_slot``, ``ac_slot`` (the reference's
    slot assignment, ``jax_pipeline.py:941-963``)."""
    uniq: list = []

    def slot_of(t):
        for i, u in enumerate(uniq):
            if u is t:
                return i
        uniq.append(t)
        return len(uniq) - 1

    dc_slot = np.zeros(4, np.int32)
    ac_slot = np.zeros(4, np.int32)
    for c in plan.components:
        dc_slot[c.index] = slot_of(dc_by_comp[c.index])
    for c in plan.components:
        ac_slot[c.index] = slot_of(ac_by_comp[c.index])
    return uniq, dc_slot, ac_slot


def quant_slots(plan, info):
    """The plan's quant tables deduplicated: (unique zig-zag tables as
    int tuples, (C,) int32 component -> unique-table index), for 1 to 4
    components."""
    keys = tuple(
        tuple(int(x) for x in info.quant_tables[
            info.components[c.index].quant_table_index])
        for c in plan.components)
    uniq = tuple(dict.fromkeys(keys))
    return uniq, np.asarray([uniq.index(k) for k in keys], np.int32)


# ---------------------------------------------------------------------------
# Host-side stream prep: destuffed per-segment word rows
# ---------------------------------------------------------------------------

def _segment_ranges(scan_data, segments_by_scan, plan):
    """Global (lo, hi) byte ranges of every plan segment in the
    concatenated scan data (vectorized; missing segments get -1)."""
    S = plan.n_segments
    scan_base = []
    base = 0
    for sd in scan_data:
        scan_base.append(base)
        base += int(np.asarray(sd).size)
    concat = (np.concatenate([np.asarray(s, np.uint8).reshape(-1)
                              for s in scan_data])
              if base else np.zeros(1, np.uint8))
    lo = np.full(S, -1, np.int64)
    hi = np.full(S, -1, np.int64)
    for scan_id, seg_list in enumerate(segments_by_scan):
        if len(seg_list) == 0:
            continue
        arr = np.asarray(seg_list, np.int64)            # (n, 2)
        sel = np.flatnonzero(plan.seg_scan == scan_id)
        n = min(sel.size, arr.shape[0])
        idx = plan.seg_scan_index[sel[:n]]
        valid = idx < arr.shape[0]
        lo[sel[:n][valid]] = scan_base[scan_id] + arr[idx[valid], 0]
        hi[sel[:n][valid]] = scan_base[scan_id] + arr[idx[valid], 1]
    return concat, lo, hi


def segment_ranges_wcap(scan_data, segments_by_scan, plan):
    """(concat bytes, lo, hi, wcap): the segment ranges and the row
    width in words that holds the longest segment with one zero word
    to spare."""
    S = plan.n_segments
    concat, lo, hi = _segment_ranges(scan_data, segments_by_scan, plan)
    max_raw = int(np.maximum(hi - lo, 1).max()) if S else 1
    return concat, lo, hi, -(-(max_raw + 4) // 4)


def build_segment_rows_from_ranges(concat, lo, hi, S: int,
                                   Wcap: int) -> np.ndarray:
    """Destuffed (S, Wcap) uint32 rows of big-endian words; a missing
    segment's row is zero."""
    from ..native import lib as native_lib

    L = native_lib()
    if L is not None:
        rows = np.zeros((S, Wcap), np.uint32)
        L.gj_build_rows(np.ascontiguousarray(concat), concat.size,
                        np.ascontiguousarray(lo), np.ascontiguousarray(hi),
                        S, rows, Wcap)
        return rows

    # NumPy fallback
    rows8 = np.zeros((S, Wcap * 4), np.uint8)
    for s in range(S):
        if lo[s] < 0 or hi[s] <= lo[s]:
            continue
        d = concat[lo[s]:hi[s]]
        prev = np.concatenate([[0], d[:-1]])
        d = d[~((d == 0) & (prev == 0xFF))]
        rows8[s, :d.size] = d
    w = rows8.reshape(S, Wcap, 4).astype(np.uint32)
    words = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | \
        (w[:, :, 2] << 8) | w[:, :, 3]
    return words.astype(np.uint32)


def build_rows(plan, scan_data, segments_by_scan) -> np.ndarray:
    """The plan's (S, wcap) destuffed rows, viewed as int32 (the dtype
    D1 takes)."""
    concat, lo, hi, wcap = segment_ranges_wcap(scan_data, segments_by_scan,
                                               plan)
    return build_segment_rows_from_ranges(concat, lo, hi, plan.n_segments,
                                          wcap).view(np.int32)


# ---------------------------------------------------------------------------
# D1: Huffman decode
# ---------------------------------------------------------------------------

def _check(rows, seg_start, seg_count, block_comp, quick, maxcode, delta,
           huffval, dc_slot, ac_slot):
    if rows.dim() != 2 or block_comp.dim() != 1 or quick.dim() != 2:
        raise ValueError("rows, block_comp and quick must be 2-, 1- and "
                         "2-dimensional")
    S, NB, n = rows.shape[0], block_comp.shape[0], quick.shape[0]
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"quick must hold 1..{MAX_SLOTS} table slots, got "
                         f"{tuple(quick.shape)}")
    i32 = torch.int32
    check_operands({"rows": (rows, rows.shape, i32),
                    "seg_start": (seg_start, (S,), i32),
                    "seg_count": (seg_count, (S,), i32),
                    "block_comp": (block_comp, (NB,), i32),
                    "quick": (quick, (n, 1 << QUICK_BITS), i32),
                    "maxcode": (maxcode, (n, 18), i32),
                    "delta": (delta, (n, 17), i32),
                    "huffval": (huffval, (n, 256), i32),
                    "dc_slot": (dc_slot, (4,), i32),
                    "ac_slot": (ac_slot, (4,), i32)}, rows.device)


def huffman_decode(rows: torch.Tensor, seg_start: torch.Tensor,
                   seg_count: torch.Tensor, block_comp: torch.Tensor,
                   quick: torch.Tensor, maxcode: torch.Tensor,
                   delta: torch.Tensor, huffval: torch.Tensor,
                   dc_slot: torch.Tensor, ac_slot: torch.Tensor) -> torch.Tensor:
    """(S, wcap) int32 rows of destuffed big-endian words -> (NB, 64)
    int32 zig-zag coefficients in scan order. Segment ``s`` holds blocks
    ``seg_start[s] .. seg_start[s] + seg_count[s] - 1``; ``block_comp``
    gives each block's component, which picks its DC prediction and,
    through ``dc_slot``/``ac_slot``, its table slots. The tables are
    :class:`DecTables`' arrays. The segments must cover disjoint blocks,
    as a plan's do."""
    _check(rows, seg_start, seg_count, block_comp, quick, maxcode, delta,
           huffval, dc_slot, ac_slot)
    if rows.device.type == "cpu":
        return huffman_decode_plain(rows, seg_start, seg_count, block_comp,
                                    quick, maxcode, delta, huffval,
                                    dc_slot, ac_slot)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    S, wcap = rows.shape
    NB = block_comp.shape[0]
    out = torch.zeros((NB, 64), dtype=torch.int32, device=rows.device)
    lib = _build.load_kernels()
    err = lib.gj_huffman_decode(
        rows.data_ptr(), wcap, seg_start.data_ptr(), seg_count.data_ptr(), S,
        block_comp.data_ptr(), quick.data_ptr(), maxcode.data_ptr(),
        delta.data_ptr(), huffval.data_ptr(), dc_slot.data_ptr(),
        ac_slot.data_ptr(), quick.shape[0], out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check_launch("gj_huffman_decode", err)
    huffman_decode.launches += 1
    return out


huffman_decode.launches = 0


def _shl1(n: torch.Tensor) -> torch.Tensor:
    """``1 << n`` with int32 semantics (0 for n >= 32), as int64."""
    v = torch.bitwise_left_shift(torch.ones_like(n), n.clamp(0, 31))
    v = torch.where(n == 31, -(1 << 31), v)
    return torch.where(n >= 32, 0, v)


def _extract_val(view: torch.Tensor, ln: torch.Tensor,
                 cat: torch.Tensor) -> torch.Tensor:
    """The ``cat`` value bits after an ``ln``-bit code at the top of the
    32-bit ``view``, sign-extended (T.81 F.12); K2's ``extract_val``."""
    sh = cat.clamp(1, 16)
    vraw = ((view << ln) & 0xFFFFFFFF) >> (32 - sh)
    vraw = torch.where(cat > 0, vraw, 0)
    half = torch.where(cat > 0, _shl1(cat - 1), 0)
    return torch.where((cat > 0) & (vraw < half), vraw - _shl1(cat) + 1,
                       vraw)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def huffman_decode_plain(rows: torch.Tensor, seg_start: torch.Tensor,
                         seg_count: torch.Tensor, block_comp: torch.Tensor,
                         quick: torch.Tensor, maxcode: torch.Tensor,
                         delta: torch.Tensor, huffval: torch.Tensor,
                         dc_slot: torch.Tensor,
                         ac_slot: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`huffman_decode`: every segment in
    lockstep, one symbol per step, in int64; the only host sync per step
    is the loop test."""
    dev = rows.device
    S, wcap = rows.shape
    NB = block_comp.shape[0]
    words = torch.cat([rows.to(torch.int64) & 0xFFFFFFFF,
                       torch.zeros((S, 2), dtype=torch.int64, device=dev)], 1)
    start, count = seg_start.to(torch.int64), seg_count.to(torch.int64)
    comp_of = block_comp.to(torch.int64)
    quick_f, huff_f = quick.to(torch.int64).view(-1), \
        huffval.to(torch.int64).view(-1)
    delta_f = delta.to(torch.int64).view(-1)
    slow_mc = maxcode.to(torch.int64)[:, QUICK_BITS + 1:17]
    dcs, acs = dc_slot.to(torch.int64), ac_slot.to(torch.int64)
    sink = NB * 64                      # target of the masked-off writes
    out = torch.zeros(NB * 64 + 1, dtype=torch.int32, device=dev)
    zero = torch.zeros(S, dtype=torch.int64, device=dev)
    bp, kp, blk = zero.clone(), zero.clone(), zero.clone()
    dcp = torch.zeros((S, 4), dtype=torch.int64, device=dev)
    while True:
        act = blk < count
        if not bool(act.any()):
            break
        g = (start + blk).clamp(0, max(NB - 1, 0))
        comp = comp_of[g]
        wp = (bp >> 5).clamp(max=wcap)
        w0 = words.gather(1, wp[:, None])[:, 0]
        w1 = words.gather(1, wp[:, None] + 1)[:, 0]
        view = (((w0 << 32) | w1) >> (32 - (bp & 31))) & 0xFFFFFFFF

        is_dc = kp == 0
        slot = torch.where(is_dc, dcs[comp], acs[comp])
        peek16 = view >> 16
        q = quick_f[slot * (1 << QUICK_BITS) + (peek16 >> (16 - QUICK_BITS))]
        s_len = (QUICK_BITS + 1) + (peek16[:, None] >= slow_mc[slot]).sum(1)
        s_code = peek16 >> (16 - s_len).clamp(min=0)
        v_idx = (s_code + delta_f[slot * 17 + s_len.clamp(max=16)]).clamp(0, 255)
        use_q = (q & 31) > 0
        sym = torch.where(use_q, q >> 5, huff_f[slot * 256 + v_idx])
        ln = torch.where(use_q, q & 31, s_len)
        bad = ln == 17
        sym = torch.where(bad, 0, sym)
        ln = torch.where(bad, 1, ln)
        cat = torch.where(is_dc, sym, sym & 15)
        run = torch.where(is_dc, 0, sym >> 4)
        val = _extract_val(view, ln, cat)

        dc_prev = dcp.gather(1, comp[:, None])[:, 0]
        dc_new = _wrap32(dc_prev + val)
        dcp.scatter_(1, comp[:, None],
                     torch.where(act & is_dc, dc_new, dc_prev)[:, None])
        pos = torch.where(is_dc, 0, kp + run)
        write = act & (is_dc | ((cat > 0) & (pos <= 63)))
        out[torch.where(write, g * 64 + pos, sink)] = \
            _wrap32(torch.where(is_dc, dc_new, val)).to(torch.int32)

        k_new = torch.where(is_dc, 1, torch.where(
            cat == 0, torch.where(run == 15, kp + 16, 64), kp + run + 1))
        bp = bp + torch.where(act, ln + cat, 0)
        done = act & (k_new >= 64)
        kp = torch.where(act, torch.where(done, 0, k_new), kp)
        blk = blk + done.to(torch.int64)
    return out[:sink].view(NB, 64)
