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

def _check(rows, seg_start, seg_count, block_comp, wide, maxcode, delta,
           huffval, dc_slot, ac_slot):
    if rows.dim() != 2 or block_comp.dim() != 1 or wide.dim() != 2:
        raise ValueError("rows, block_comp and wide must be 2-, 1- and "
                         "2-dimensional")
    S, NB, n = rows.shape[0], block_comp.shape[0], wide.shape[0]
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"wide must hold 1..{MAX_SLOTS} table slots, got "
                         f"{tuple(wide.shape)}")
    i32 = torch.int32
    check_operands({"rows": (rows, rows.shape, i32),
                    "seg_start": (seg_start, (S,), i32),
                    "seg_count": (seg_count, (S,), i32),
                    "block_comp": (block_comp, (NB,), i32),
                    "wide": (wide, (n, 1 << WIDE_BITS), i32),
                    "maxcode": (maxcode, (n, 18), i32),
                    "delta": (delta, (n, 17), i32),
                    "huffval": (huffval, (n, 256), i32),
                    "dc_slot": (dc_slot, (4,), i32),
                    "ac_slot": (ac_slot, (4,), i32)}, rows.device)


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
    S, wcap = rows.shape
    NB = block_comp.shape[0]
    words = torch.cat([rows.to(torch.int64) & 0xFFFFFFFF,
                       torch.zeros((S, 2), dtype=torch.int64, device=dev)], 1)
    start, count = seg_start.to(torch.int64), seg_count.to(torch.int64)
    comp_of = block_comp.to(torch.int64)
    wide_f, huff_f = wide.to(torch.int64).view(-1), \
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
