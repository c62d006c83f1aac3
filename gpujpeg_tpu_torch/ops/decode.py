"""Segment-parallel Huffman decode of the device decode: host prep and D1.

Counterpart of the JAX reference's ``gpujpeg_tpu/ops/pallas_decode.py``
(host half) and of its three Huffman decoders. The host destuffs every
restart segment into a row of big-endian u32 words
(:func:`build_segment_rows_from_ranges`, the native ``gj_build_rows``);
the decode tables (:func:`build_dec_tables_v2`) and the DC-first table
slots (:func:`table_slots`) are the reference's, bit for bit.

**D1** :func:`huffman_decode` (``csrc/huffman_decode.cu``) decodes the
rows to zig-zag coefficients in scan order, one thread per segment
(through the first-level table :func:`wide_quick_tables`, whose entries
are the reference lookup's by construction, and the reference's maxcode
compares where it misses), for any plan: any block
-> component map (interleaved MCUs of 3 to 10 blocks, 1 to 4
components) and any row width. It is the counterpart of
the Huffman half of ``pallas_decode_v3.make_decode_kernel_v3`` (K2), of
its coefficient form ``run_raw`` (K4, rows of at most ``V3_WCAP_MAX`` =
384 words) and of the v2 decoder ``pallas_decode.make_decode_kernel``
(K5, longer rows). Its plain torch version :func:`huffman_decode_plain`
decodes all segments in lockstep, one symbol per step; it also stands
for the reference's XLA v1 decoder (``huffman_decode.py:93``, its form
on a backend without Pallas). The wrapper takes the plain version only
for tensors on the CPU.

**D1L** :func:`huffman_lanes` (``csrc/huffman_lanes.cu``) decodes the
scans of a stream without restart markers, each one segment a row of
:func:`build_rows`, by self-synchronising lanes of
:data:`LANE_BITS` bits: to D1's coefficients, bit for bit, with many
threads a segment where D1 has one (Klein & Wiseman 2003; Weissenberger &
Schmidt, arXiv 2111.09219). Its plain torch version
:func:`huffman_lanes_plain` runs the same passes in lockstep.

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
#: lookahead bits of D1's first-level table (``wide_quick_tables``)
WIDE_BITS = 11


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


def reference_lookup(dec: DecTables,
                     peek16: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, length), each (n_slots, P) int64, of the reference's
    lookup (K2's ``lookup_sym``) of the 16-bit peeks ``peek16`` (P,) in
    every slot: the quick table, else T.81 F.16's length by the maxcode
    compares over 9..16 and ``huffval[clip(code + delta, 0, 255)]``; an
    invalid code (length 17) is symbol 0 of one bit."""
    peek = np.asarray(peek16, np.int64)[None, :]
    q = dec.quick[:, peek[0] >> (16 - QUICK_BITS)].astype(np.int64)
    mc = dec.maxcode[:, QUICK_BITS + 1:17].astype(np.int64)
    s_len = QUICK_BITS + 1 + (peek[:, :, None] >= mc[:, None, :]).sum(2)
    code = peek >> np.maximum(16 - s_len, 0)
    v = np.clip(code + np.take_along_axis(
        dec.delta.astype(np.int64), np.minimum(s_len, 16), 1), 0, 255)
    hit = (q & 31) > 0
    sym = np.where(hit, q >> 5, np.take_along_axis(
        dec.huffval.astype(np.int64), v, 1))
    ln = np.where(hit, q & 31, s_len)
    bad = ln == 17
    return np.where(bad, 0, sym), np.where(bad, 1, ln)


def wide_quick_tables(dec: DecTables, bits: int = WIDE_BITS) -> np.ndarray:
    """D1's first-level table, (n_slots, 2**bits) int32 ``sym << 5 |
    len``: for each ``bits``-bit prefix, the reference lookup's (symbol,
    length) where it is the same for every 16-bit peek that starts with
    the prefix and the length is at most ``bits``; else 0 (D1 then takes
    the reference's maxcode compares). So a hit equals the reference by
    construction."""
    sym, ln = reference_lookup(dec, np.arange(1 << 16))
    n = sym.shape[0]
    sym = sym.reshape(n, 1 << bits, -1)
    ln = ln.reshape(n, 1 << bits, -1)
    same = ((sym == sym[..., :1]).all(2) & (ln == ln[..., :1]).all(2)
            & (ln[..., 0] <= bits))
    return np.where(same, (sym[..., 0] << 5) | ln[..., 0], 0).astype(np.int32)


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
                                   Wcap: int, words=None) -> np.ndarray:
    """Destuffed (S, Wcap) uint32 rows of big-endian words; a missing
    segment's row is zero. ``words``, an (S,) int64 array where given,
    gets each segment's destuffed length in words."""
    from ..native import lib as native_lib

    L = native_lib()
    if L is not None:
        rows = np.zeros((S, Wcap), np.uint32)
        concat = np.ascontiguousarray(concat)
        lo, hi = np.ascontiguousarray(lo), np.ascontiguousarray(hi)
        if words is None:
            L.gj_build_rows(concat, concat.size, lo, hi, S, rows, Wcap)
        else:                   # the native builder returns the longest
            for s in range(S):
                words[s] = L.gj_build_rows(concat, concat.size, lo[s:s + 1],
                                           hi[s:s + 1], 1, rows[s], Wcap)
        return rows

    # NumPy fallback
    rows8 = np.zeros((S, Wcap * 4), np.uint8)
    if words is not None:
        words[:] = 0
    for s in range(S):
        if lo[s] < 0 or hi[s] <= lo[s]:
            continue
        d = concat[lo[s]:hi[s]]
        prev = np.concatenate([[0], d[:-1]])
        d = d[~((d == 0) & (prev == 0xFF))]
        rows8[s, :d.size] = d
        if words is not None:
            words[s] = -(-d.size // 4)
    w = rows8.reshape(S, Wcap, 4).astype(np.uint32)
    be = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | \
        (w[:, :, 2] << 8) | w[:, :, 3]
    return be.astype(np.uint32)


def _pack_bits(fields) -> np.ndarray:
    """(value, width) bit fields, MSB first, -> big-endian u32 words."""
    bits = "".join(format(int(v), f"0{w}b") for v, w in fields if w)
    bits += "0" * (-len(bits) % 32)
    return np.asarray([int(bits[i:i + 32], 2)
                       for i in range(0, len(bits), 32)], np.uint32)


def _overflow_block(rng, dc, ac) -> list:
    """One block's bit fields that end where k + run passes 63 (K2's
    corrupt-stream rule): a DC, three ZRLs (k = 49) and ``k0 - 49`` single
    coefficients, then a ZRL or a coefficient whose run passes 63, with
    its value bits."""
    def sym(t, s, cat=0):
        return [(t.ehufco[s], t.ehufsi[s]),
                (rng.integers(0, 1 << cat) if cat else 0, cat)]
    k0 = int(rng.integers(49, 64))
    out = sym(dc, 0) + sym(ac, 0xF0) * 3 + sym(ac, 0x01, 1) * (k0 - 49)
    if rng.integers(0, 2):
        return out + sym(ac, 0xF0)
    run = int(rng.integers(64 - k0, 16))
    cat = int(rng.integers(1, 11))
    return out + sym(ac, (run << 4) | cat, cat)


def _coded_block(rng, dc, ac) -> list:
    """One valid block's bit fields: a DC difference and sparse AC values
    up to 1023 after runs of up to 40 zeros (ZRLs included), EOB unless
    the last value is at 63."""
    def val(v):
        c = int(abs(v)).bit_length()
        return [(v if v > 0 else v + (1 << c) - 1, c)]
    d = int(rng.integers(-2047, 2048))
    c = int(abs(d)).bit_length()
    out = [(dc.ehufco[c], dc.ehufsi[c])] + (val(d) if c else [])
    k = 1
    while True:
        run = int(rng.integers(0, 41))
        if k + run > 63:
            break
        k += run
        while run > 15:
            out.append((ac.ehufco[0xF0], ac.ehufsi[0xF0]))
            run -= 16
        v = int(rng.integers(1, 1024)) * (1 if rng.integers(0, 2) else -1)
        c = int(abs(v)).bit_length()
        s = (run << 4) | c
        out += [(ac.ehufco[s], ac.ehufsi[s])] + val(v)
        k += 1
        if k > 63:
            return out
    return out + [(ac.ehufco[0], ac.ehufsi[0])]


def envelope_rows(rng: np.random.Generator, zrl16: bool = False,
                  n_seg: int = 128, blocks: int = 4, wcap: int = 8):
    """D1's corrupt-stream envelope: (rows (n_seg, wcap) int32, seg_start,
    seg_count, block_comp, DecTables, dc_slot, ac_slot), ``blocks``
    blocks a segment, segment s of component ``s % 2`` with the Annex K
    luma (0) or chroma (1) tables, the AC ZRL given a 16-bit code when
    ``zrl16`` (``entropy.envelope_huffman_spec``). Segment kinds in
    turn: random words (corrupt streams), all ones (invalid codes), all
    zeros, blocks that end where k + run passes 63, and valid blocks with
    long runs and large values (long codes). ``wcap`` is short, so most
    rows are cut and reads run past them (zero words)."""
    from ..tables import build_huffman_table
    from ..types import ComponentType, HuffmanType
    from .entropy import envelope_huffman_spec
    spec = envelope_huffman_spec(zrl16)
    tables = [tuple(build_huffman_table(*spec[ct, ht])
                    for ht in (HuffmanType.DC, HuffmanType.AC))
              for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)]
    rows = np.zeros((n_seg, wcap), np.uint32)
    for s in range(n_seg):
        dc, ac = tables[s % 2]
        kind = s % 5
        if kind == 0:
            rows[s] = rng.integers(0, 1 << 32, wcap, dtype=np.uint64)
        elif kind == 1:
            rows[s] = 0xFFFFFFFF
        elif kind in (3, 4):
            make = _overflow_block if kind == 3 else _coded_block
            words = _pack_bits([f for _ in range(blocks)
                                for f in make(rng, dc, ac)])[:wcap]
            rows[s, :words.size] = words
    dec = build_dec_tables_v2([tables[0][0], tables[1][0], tables[0][1],
                               tables[1][1]])
    return (rows.view(np.int32), np.arange(n_seg, dtype=np.int32) * blocks,
            np.full(n_seg, blocks, np.int32),
            np.repeat(np.arange(n_seg, dtype=np.int32) % 2, blocks), dec,
            np.array([0, 1, 1, 1], np.int32), np.array([2, 3, 3, 3], np.int32))


def build_rows(plan, scan_data, segments_by_scan, words=None) -> np.ndarray:
    """The plan's (S, wcap) destuffed rows, viewed as int32 (the dtype
    D1 takes); ``words``: :func:`build_segment_rows_from_ranges`'."""
    concat, lo, hi, wcap = segment_ranges_wcap(scan_data, segments_by_scan,
                                               plan)
    return build_segment_rows_from_ranges(concat, lo, hi, plan.n_segments,
                                          wcap, words).view(np.int32)


# ---------------------------------------------------------------------------
# D1L: the lane route of scans without restart markers
# ---------------------------------------------------------------------------

#: bits of a lane of :func:`huffman_lanes` (PERF.md: the width measured on
#: the card)
LANE_BITS = 768
#: segments (scans) and blocks of an MCU the lane route takes: T.81's most
LANE_MAX_SEGMENTS, LANE_MAX_PHASE = 4, 10
#: the int32 fields a lane holds in :func:`huffman_lanes`' scratch, and the
#: most CTAs of its settle kernel (each keeps 5 totals there)
LANE_FIELDS, LANE_MAX_GRID = 15, 4096


def lane_eligible(plan) -> bool:
    """True when a plan's decode takes the lane route: no restart markers,
    so each scan is one segment, with at most four scans and ten blocks
    an MCU."""
    return (plan.params.restart_interval == 0
            and 1 <= plan.n_segments <= LANE_MAX_SEGMENTS
            and all(s.blocks_per_mcu <= LANE_MAX_PHASE for s in plan.scans))


def lane_segments(plan) -> np.ndarray:
    """The plan's part of :func:`lane_geometry`: per segment (rows) its
    first block, block count, blocks an MCU (1 for a scan of one
    component) and the component of each block of an MCU, (S, 3 + 10)
    int32."""
    S = plan.n_segments
    segs = np.zeros((S, 3 + LANE_MAX_PHASE), np.int32)
    NB = len(plan.block_comp)
    for s in range(S):
        scan = plan.scans[int(plan.seg_scan[s])]
        bpm = scan.blocks_per_mcu if len(scan.comp_indices) > 1 else 1
        start = int(plan.seg_block_start[s])
        segs[s, :3] = start, int(plan.seg_block_count[s]), bpm
        for p in range(bpm):
            if start + p < NB:
                segs[s, 3 + p] = plan.block_comp[start + p]
    return segs


def lane_geometry(segs: np.ndarray, bits, lane_bits: int = LANE_BITS
                  ) -> np.ndarray:
    """The lane route's geometry, the int32 array that
    ``csrc/huffman_lanes.cu``'s ``LaneGeo`` reads: n_seg, n_lanes,
    lane_bits, the most lanes of one segment, each segment's first lane
    (and n_lanes), data bits, first block, block count, blocks an MCU and
    the components of an MCU's blocks (:func:`lane_segments`). A segment
    of ``bits`` has ``max(1, ceil(bits / lane_bits))`` lanes."""
    S = segs.shape[0]
    bits = np.asarray(bits, np.int64)
    n = np.maximum(1, -(-bits // lane_bits))
    if not 1 <= S <= LANE_MAX_SEGMENTS or lane_bits < 1 \
            or (n * lane_bits > 1 << 30).any():
        raise ValueError(f"the lane route takes 1..{LANE_MAX_SEGMENTS} "
                         f"segments of at most 2**30 bits, got {S} of "
                         f"{bits.tolist()}")
    pad = np.zeros(LANE_MAX_SEGMENTS, np.int64)
    lane0 = np.zeros(LANE_MAX_SEGMENTS + 1, np.int64)
    lane0[1:S + 1] = np.cumsum(n)
    lane0[S + 1:] = lane0[S]

    def col(a):
        out = pad.copy()
        out[:S] = a
        return out
    comps = np.zeros((LANE_MAX_SEGMENTS, LANE_MAX_PHASE), np.int64)
    comps[:S] = segs[:, 3:]
    return np.concatenate([
        [S, lane0[S], lane_bits, n.max()], lane0, col(bits),
        col(segs[:, 0]), col(segs[:, 1]), col(segs[:, 2]),
        comps.reshape(-1)]).astype(np.int32)


def _geometry_fields(geo: np.ndarray) -> dict:
    """:func:`lane_geometry`'s array by field (the segments' fields cut to
    n_seg)."""
    S = int(geo[0])
    m = LANE_MAX_SEGMENTS
    o = 4 + m + 1
    return {"n_seg": S, "n_lanes": int(geo[1]), "lane_bits": int(geo[2]),
            "max_lanes": int(geo[3]), "lane0": geo[4:4 + S + 1],
            "bits": geo[o:o + S], "start": geo[o + m:o + m + S],
            "count": geo[o + 2 * m:o + 2 * m + S],
            "bpm": geo[o + 3 * m:o + 3 * m + S],
            "comp": geo[o + 4 * m:].reshape(m, LANE_MAX_PHASE)[:S]}


# ---------------------------------------------------------------------------
# D1: Huffman decode
# ---------------------------------------------------------------------------

def _table_operands(rows, wide, maxcode, delta, huffval, dc_slot,
                    ac_slot) -> dict:
    """:func:`entropy._check`'s operands of the rows and the tables."""
    if rows.dim() != 2 or wide.dim() != 2:
        raise ValueError("rows and wide must be 2-dimensional")
    n = wide.shape[0]
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"wide must hold 1..{MAX_SLOTS} table slots, got "
                         f"{tuple(wide.shape)}")
    i32 = torch.int32
    return {"rows": (rows, rows.shape, i32),
            "wide": (wide, (n, 1 << WIDE_BITS), i32),
            "maxcode": (maxcode, (n, 18), i32),
            "delta": (delta, (n, 17), i32),
            "huffval": (huffval, (n, 256), i32),
            "dc_slot": (dc_slot, (4,), i32),
            "ac_slot": (ac_slot, (4,), i32)}


def _check(rows, seg_start, seg_count, block_comp, wide, maxcode, delta,
           huffval, dc_slot, ac_slot):
    ops = _table_operands(rows, wide, maxcode, delta, huffval, dc_slot,
                          ac_slot)
    if block_comp.dim() != 1:
        raise ValueError("block_comp must be 1-dimensional")
    S, NB, i32 = rows.shape[0], block_comp.shape[0], torch.int32
    check_operands({**ops, "seg_start": (seg_start, (S,), i32),
                    "seg_count": (seg_count, (S,), i32),
                    "block_comp": (block_comp, (NB,), i32)}, rows.device)


def check_cover(seg_start, seg_count, NB: int) -> None:
    """Raise unless the segments, given as host arrays, cover blocks
    ``[0, NB)`` exactly once: :func:`huffman_decode`'s precondition, since
    its kernel writes only the blocks of its segments."""
    st = np.asarray(seg_start, np.int64)
    cnt = np.asarray(seg_count, np.int64)
    live = cnt > 0
    order = np.argsort(st[live], kind="stable")
    lo, hi = st[live][order], (st + cnt)[live][order]
    first, end = (int(lo[0]), int(hi[-1])) if lo.size else (0, 0)
    if (cnt < 0).any() or first != 0 or end != NB \
            or not np.array_equal(lo[1:], hi[:-1]):
        raise ValueError(f"the segments (seg_start, seg_count) do not cover "
                         f"blocks 0..{NB - 1} exactly once")


def huffman_decode(rows: torch.Tensor, seg_start: torch.Tensor,
                   seg_count: torch.Tensor, block_comp: torch.Tensor,
                   wide: torch.Tensor, maxcode: torch.Tensor,
                   delta: torch.Tensor, huffval: torch.Tensor,
                   dc_slot: torch.Tensor, ac_slot: torch.Tensor) -> torch.Tensor:
    """(S, wcap) int32 rows of destuffed big-endian words -> (NB, 64)
    int32 zig-zag coefficients in scan order. Segment ``s`` holds blocks
    ``seg_start[s] .. seg_start[s] + seg_count[s] - 1``; ``block_comp``
    gives each block's component, which picks its DC prediction and,
    through ``dc_slot``/``ac_slot``, its table slots. ``wide`` is the
    :func:`wide_quick_tables` of the :class:`DecTables` whose other
    arrays follow it. The output is not cleared: the segments must cover
    blocks ``[0, NB)`` exactly once, as a plan's do (:func:`check_cover`
    checks a segment map on the host). On the card the rows must start on
    a 16-byte boundary."""
    _check(rows, seg_start, seg_count, block_comp, wide, maxcode, delta,
           huffval, dc_slot, ac_slot)
    if rows.device.type == "cpu":
        return huffman_decode_plain(rows, seg_start, seg_count, block_comp,
                                    wide, maxcode, delta, huffval,
                                    dc_slot, ac_slot)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")
    S, wcap = rows.shape
    NB = block_comp.shape[0]
    out = torch.empty((NB, 64), dtype=torch.int32, device=rows.device)
    _build.launch(
        "gj_huffman_decode", rows.device, rows.data_ptr(), wcap,
        seg_start.data_ptr(), seg_count.data_ptr(), S, block_comp.data_ptr(),
        wide.data_ptr(), maxcode.data_ptr(), delta.data_ptr(),
        huffval.data_ptr(), dc_slot.data_ptr(), ac_slot.data_ptr(),
        wide.shape[0], out.data_ptr())
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


def _plain_tables(wide, maxcode, delta, huffval) -> tuple:
    """The plain versions' lookup tables, flat int64: (wide, huffval,
    delta, the maxcode columns of lengths 9..16)."""
    return (wide.to(torch.int64).view(-1), huffval.to(torch.int64).view(-1),
            delta.to(torch.int64).view(-1),
            maxcode.to(torch.int64)[:, QUICK_BITS + 1:17])


def _words_plain(rows: torch.Tensor) -> torch.Tensor:
    """(S, wcap) int32 rows -> (S, wcap + 2) int64 words, two zero words
    past each row."""
    S = rows.shape[0]
    return torch.cat([rows.to(torch.int64) & 0xFFFFFFFF,
                      torch.zeros((S, 2), dtype=torch.int64,
                                  device=rows.device)], 1)


def _view_plain(words: torch.Tensor, row, bp: torch.Tensor) -> torch.Tensor:
    """The 32 bits at bit ``bp`` of row ``row`` (each lane's own row where
    ``row`` is None) of :func:`_words_plain`'s words; zeros past a row."""
    wcap = words.shape[1] - 2
    wp = (bp >> 5).clamp(max=wcap)
    if row is None:
        w0 = words.gather(1, wp[:, None])[:, 0]
        w1 = words.gather(1, wp[:, None] + 1)[:, 0]
    else:
        w0, w1 = words[row, wp], words[row, wp + 1]
    return (((w0 << 32) | w1) >> (32 - (bp & 31))) & 0xFFFFFFFF


def _symbol_plain(view: torch.Tensor, slot: torch.Tensor, is_dc: torch.Tensor,
                  tabs: tuple) -> tuple:
    """(cat, run, value, bits used) of the symbol at the top of each
    32-bit ``view`` in table ``slot``: the ``wide`` table, else the
    reference's maxcode compares over lengths 9..16; an invalid code is
    symbol 0 of one bit (D1's ``lookup_sym``)."""
    wide_f, huff_f, delta_f, slow_mc = tabs
    peek16 = view >> 16
    q = wide_f[slot * (1 << WIDE_BITS) + (peek16 >> (16 - WIDE_BITS))]
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
    return cat, run, _extract_val(view, ln, cat), ln + cat


def _next_k(k: torch.Tensor, cat: torch.Tensor,
            run: torch.Tensor) -> torch.Tensor:
    """The zig-zag index after a symbol at ``k`` (64 or more: the block is
    done): after a DC 1, after a ZRL k + 16, after an EOB 64."""
    return torch.where(k == 0, 1, torch.where(
        cat == 0, torch.where(run == 15, k + 16, 64), k + run + 1))


def huffman_decode_plain(rows: torch.Tensor, seg_start: torch.Tensor,
                         seg_count: torch.Tensor, block_comp: torch.Tensor,
                         wide: torch.Tensor, maxcode: torch.Tensor,
                         delta: torch.Tensor, huffval: torch.Tensor,
                         dc_slot: torch.Tensor,
                         ac_slot: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`huffman_decode`: every segment in
    lockstep, one symbol per step, in int64; the only host sync per step
    is the loop test. A miss in ``wide`` takes the reference's maxcode
    compares over lengths 9..16."""
    dev = rows.device
    S = rows.shape[0]
    NB = block_comp.shape[0]
    words = _words_plain(rows)
    start, count = seg_start.to(torch.int64), seg_count.to(torch.int64)
    comp_of = block_comp.to(torch.int64)
    tabs = _plain_tables(wide, maxcode, delta, huffval)
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
        view = _view_plain(words, None, bp)

        is_dc = kp == 0
        cat, run, val, used = _symbol_plain(
            view, torch.where(is_dc, dcs[comp], acs[comp]), is_dc, tabs)

        dc_prev = dcp.gather(1, comp[:, None])[:, 0]
        dc_new = _wrap32(dc_prev + val)
        dcp.scatter_(1, comp[:, None],
                     torch.where(act & is_dc, dc_new, dc_prev)[:, None])
        pos = torch.where(is_dc, 0, kp + run)
        write = act & (is_dc | ((cat > 0) & (pos <= 63)))
        out[torch.where(write, g * 64 + pos, sink)] = \
            _wrap32(torch.where(is_dc, dc_new, val)).to(torch.int32)

        k_new = _next_k(kp, cat, run)
        bp = bp + torch.where(act, used, 0)
        done = act & (k_new >= 64)
        kp = torch.where(act, torch.where(done, 0, k_new), kp)
        blk = blk + done.to(torch.int64)
    return out[:sink].view(NB, 64)


# ---------------------------------------------------------------------------
# D1L: Huffman decode of scans without restart markers, by lanes
# ---------------------------------------------------------------------------

def huffman_lanes(rows: torch.Tensor, geo: np.ndarray, n_blocks: int,
                  wide: torch.Tensor, maxcode: torch.Tensor,
                  delta: torch.Tensor, huffval: torch.Tensor,
                  dc_slot: torch.Tensor, ac_slot: torch.Tensor) -> tuple:
    """(S, wcap) int32 rows, one segment a row, each a whole scan without
    restart markers -> ((NB, 64) int32 zig-zag coefficients in scan order,
    the rounds the lanes took to settle as a (1,) int32 tensor on the
    rows' device). ``geo`` is :func:`lane_geometry` of the plan's
    segments; the tables are :func:`huffman_decode`'s. The coefficients
    equal :func:`huffman_decode`'s on the same rows, bit for bit: each
    segment is cut into lanes that decode at once, from guessed starts
    until every start is the end of the lane before it
    (``csrc/huffman_lanes.cu``). The segments must cover blocks ``[0,
    n_blocks)`` exactly once (:func:`check_cover`)."""
    f = _geometry_fields(geo)
    NB = int(n_blocks)
    if rows.dim() != 2 or rows.shape[0] != f["n_seg"]:
        raise ValueError(f"rows must be (S, wcap) with the lane geometry's "
                         f"S = {f['n_seg']}, got {tuple(rows.shape)}")
    check_operands(_table_operands(rows, wide, maxcode, delta, huffval,
                                   dc_slot, ac_slot), rows.device)
    ends = f["start"].astype(np.int64) + f["count"]
    if (f["start"] < 0).any() or (ends > NB).any():
        raise ValueError(f"the lane geometry's segments pass block {NB}")
    if rows.device.type == "cpu":
        return huffman_lanes_plain(rows, geo, NB, wide, maxcode, delta,
                                   huffval, dc_slot, ac_slot)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    geo = np.ascontiguousarray(geo, np.int32)
    out = torch.empty((NB, 64), dtype=torch.int32, device=rows.device)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")
    flags = LANE_FIELDS * f["n_lanes"]
    scratch = torch.empty(flags + 4 + 5 * LANE_MAX_GRID, dtype=torch.int32,
                          device=rows.device)
    _build.launch(
        "gj_huffman_lanes", rows.device, rows.data_ptr(), rows.shape[1],
        geo.ctypes.data, wide.data_ptr(), maxcode.data_ptr(),
        delta.data_ptr(), huffval.data_ptr(), dc_slot.data_ptr(),
        ac_slot.data_ptr(), wide.shape[0], scratch.data_ptr(),
        out.data_ptr())
    huffman_lanes.launches += 1
    huffman_lanes.lanes += f["n_lanes"]
    return out, scratch[flags + 3:flags + 4]


huffman_lanes.launches = 0
#: lanes launched, over the process
huffman_lanes.lanes = 0


def _segmented_exclusive(x: torch.Tensor, lane0: torch.Tensor,
                         seg: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` (L, ...) over the earlier lanes of each lane's segment
    (``lane0``: each segment's first lane, ``seg``: each lane's)."""
    before = torch.cumsum(x, 0) - x
    return before - before[lane0[seg]]


def huffman_lanes_plain(rows: torch.Tensor, geo: np.ndarray, n_blocks: int,
                        wide: torch.Tensor, maxcode: torch.Tensor,
                        delta: torch.Tensor, huffval: torch.Tensor,
                        dc_slot: torch.Tensor,
                        ac_slot: torch.Tensor) -> tuple:
    """Plain torch version of :func:`huffman_lanes`, the same three passes
    in lockstep, one symbol of every live lane a step, in int64: the
    rounds (each decodes the lanes whose start moved, then moves each
    start to the end of the lane before it), the exclusive sums, the
    write."""
    dev = rows.device
    f = _geometry_fields(geo)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    L, W = f["n_lanes"], f["lane_bits"]
    lane0, bpm, comps = t(f["lane0"]), t(f["bpm"]), t(f["comp"])
    start, count = t(f["start"]), t(f["count"])
    words = _words_plain(rows)
    tabs = _plain_tables(wide, maxcode, delta, huffval)
    dcs, acs = dc_slot.to(torch.int64), ac_slot.to(torch.int64)
    idx = torch.arange(L, device=dev)
    seg = torch.repeat_interleave(torch.arange(f["n_seg"], device=dev),
                                  lane0[1:] - lane0[:-1])
    j = idx - lane0[seg]
    first, last = j == 0, idx == lane0[seg + 1] - 1
    prev = (idx - 1).clamp(min=0)

    def step(i, pos, phase, k):
        """One symbol of lanes ``i`` at (pos, phase, k): (cat, run, value,
        bits used, component)."""
        s = seg[i]
        comp = comps[s, phase]
        is_dc = k == 0
        slot = torch.where(is_dc, dcs[comp], acs[comp])
        return (*_symbol_plain(_view_plain(words, s, pos), slot, is_dc,
                               tabs), comp)

    # the rounds
    s_bit, s_pk = j * W, torch.zeros_like(j)
    e_bit, e_pk, nblk = s_bit.clone(), s_pk.clone(), torch.zeros_like(j)
    dc = torch.zeros((L, 4), dtype=torch.int64, device=dev)
    todo, rounds = ~last, 0
    while rounds < f["max_lanes"]:
        rounds += 1
        i = torch.nonzero(todo)[:, 0]
        pos, phase, k = s_bit[i], s_pk[i] >> 6, s_pk[i] & 63
        stop = (j[i] + 1) * W
        nb = torch.zeros_like(pos)
        d = torch.zeros((len(i), 4), dtype=torch.int64, device=dev)
        live = pos < stop
        while bool(live.any()):
            cat, run, val, used, comp = step(i, pos, phase, k)
            d[torch.arange(len(i), device=dev), comp] += torch.where(
                live & (k == 0), val, 0)
            k_new = _next_k(k, cat, run)
            done = k_new >= 64
            pos = torch.where(live, pos + used, pos)
            k = torch.where(live, torch.where(done, 0, k_new), k)
            nb = nb + (live & done).to(torch.int64)
            phase = torch.where(live & done, (phase + 1) % bpm[seg[i]],
                                phase)
            live = live & (pos < stop)
        e_bit[i], e_pk[i], nblk[i], dc[i] = pos, phase << 6 | k, nb, d
        moved = ~first & ((e_bit[prev] != s_bit) | (e_pk[prev] != s_pk))
        s_bit = torch.where(moved, e_bit[prev], s_bit)
        s_pk = torch.where(moved, e_pk[prev], s_pk)
        todo = moved & ~last
        if not bool(todo.any()):
            break

    # each lane's first block and DC predictors
    blk0 = _segmented_exclusive(nblk, lane0, seg)
    carry = _wrap32(_segmented_exclusive(dc, lane0, seg))

    # the write: each lane's blocks, their DC symbols in its bits
    k0 = s_pk & 63
    own0 = blk0 + (k0 > 0).to(torch.int64)
    nxt = (idx + 1).clamp(max=L - 1)
    end = torch.where(last, count[seg], torch.minimum(
        count[seg], blk0[nxt] + ((s_pk[nxt] & 63) > 0).to(torch.int64)))
    n_own = (end - own0).clamp(min=0)
    NB = int(n_blocks)
    sink = NB * 64
    out = torch.zeros(NB * 64 + 1, dtype=torch.int32, device=dev)
    i = torch.nonzero(n_own > 0)[:, 0]
    pos, phase, k = s_bit[i], s_pk[i] >> 6, k0[i]
    pred, own = carry[i].clone(), n_own[i]
    skipping, done_blocks = k > 0, torch.zeros_like(pos)
    rows_i = torch.arange(len(i), device=dev)
    live = skipping | (done_blocks < own)
    while bool(live.any()):
        cat, run, val, used, comp = step(i, pos, phase, k)
        write = live & ~skipping
        blk = start[seg[i]] + own0[i] + done_blocks
        is_dc = k == 0
        now = _wrap32(pred[rows_i, comp] + val)
        pred[rows_i, comp] = torch.where(write & is_dc, now,
                                         pred[rows_i, comp])
        at = torch.where(is_dc, 0, k + run)
        put = write & (is_dc | ((cat > 0) & (at <= 63)))
        out[torch.where(put, blk * 64 + at, sink)] = \
            _wrap32(torch.where(is_dc, now, val)).to(torch.int32)
        k_new = _next_k(k, cat, run)
        done = live & (k_new >= 64)
        pos = torch.where(live, pos + used, pos)
        k = torch.where(live, torch.where(done, 0, k_new), k)
        phase = torch.where(done, (phase + 1) % bpm[seg[i]], phase)
        done_blocks = done_blocks + (done & ~skipping).to(torch.int64)
        skipping = skipping & ~done
        live = skipping | (done_blocks < own)
    return (out[:sink].view(NB, 64),
            torch.tensor([rounds], dtype=torch.int32, device=dev))
