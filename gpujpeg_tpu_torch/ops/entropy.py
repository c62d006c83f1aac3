"""Segment-parallel Huffman coding of the device encode: E2 and E3.

Counterpart of the JAX reference's ``gpujpeg_tpu/ops/entropy_v2.py`` on
the main path. There one Pallas kernel (K1, ``encode_dct_fused_full``)
does DC prediction, symbol synthesis and code lookup, per-block bit
strings, a lane-packed tree merge of each segment, byte stuffing and RST
append in VMEM tiles. The tree merge, lane packing and window matmuls
answered Mosaic's limits; on the card two plain kernels do the same
work:

* **E2** :func:`huffman_blocks` (``csrc/huffman_blocks.cu``): one warp
  per block, a lane per two coefficients (run lengths from ballot masks,
  bit offsets from a warp scan), writes the block's bit string into a
  scratch row of one worst-case capacity (:data:`BLOCK_CAP_WORDS`) and
  its bit length.
* **E3** :func:`merge_stuff` (``csrc/merge_stuff.cu``): one warp per
  segment concatenates its blocks' strings in steps of up to 32 blocks
  (bit offsets from a warp scan, the strings ORed into a shared window),
  pads with 1-bits, stuffs 0xFF bytes and appends the RST marker.

Capacities are worst-case, so nothing overflows and the reference's
tier-1/tier-2 budgets and overflow retry have no counterpart here. The
output keeps the reference's ``(out, out_len, seg_bits, n_ff)`` contract
that compaction reads. Each wrapper takes its plain torch version
(:func:`huffman_blocks_plain`, :func:`merge_stuff_plain`) only for
tensors on the CPU.

E2 reads each block's DC predecessor (``plan.dc_pred_idx``) and class,
and E3 each segment's first block and block count, so the two serve
every segment geometry: interleaved MCU order, any sampling, 1, 3 or 4
components, short last segments. On the general encode route (after E0
and E1p) they stand for the reference's entropy kernels that
``encode_rows_arrays`` and ``merge_and_stuff`` (``entropy_v2.py:
1757-1813``) and the fused stage 1 dispatch between:

* K6 ``block_chunks_dct_fused`` (stage 1 half; its DCT is E1p's) and K7
  ``block_chunks_pallas``: E2;
* K8 ``merge_stuff_packed`` (``bps*W == 128``), K9
  ``merge_segments_packed`` (``bps*W <= 512``, both powers of two), K10
  ``merge_segments_pallas`` (``cap_seg_words <= 126``) and K11
  ``stuff_and_rst_pallas``: E3.

``bps`` (blocks per segment padded to a power of two), ``W`` (words per
block of the tier-1 byte budget) and ``cap_seg_words`` exist only to
pick among those TPU kernels; E2 and E3 need none of them.
``tests/test_torch_entropy_general.py`` holds the plain E2 + E3 bit for
bit against each of K6-K11 in interpret mode, on the JAX package's own
coefficients.

* **E12** :func:`dct_huffman_blocks` (``csrc/dct_huffman_blocks.cu``):
  E1's separable DCT passes (``csrc/dct8.cuh``) and E1p's quantisation
  (its quotients, bit for bit) fused with E2's warp walk
  (``csrc/block_walk.cuh``, which E2 calls too), so the coefficients
  never reach device memory: the counterpart of K12
  ``block_chunks_dct_pallas`` (``entropy_v2.py:637``), which only the
  JAX package's stage-1 probe scripts call, and with its ``stop`` modes
  of their ablation kernel (``scripts/ablate_stage1.py``). Its operands
  are K12's contract unpacked from pair rows (:func:`from_pair_rows`);
  the port's measurement tools (``gpujpeg_tpu_torch/tools/``) drive it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build
from ..plan import CoderPlan
from ..tables import (DEFAULT_HUFFMAN_BITS, DEFAULT_HUFFMAN_VALUES,
                      HuffmanTable, dct_zigzag_operator)
from ..types import ComponentType, HuffmanType
from .huffman_encode import build_enc_geometry

#: worst-case bytes of one block's bit string: 64 chunks of at most 27
#: bits (16-bit code + 11 value bits) is 216 bytes, rounded up to whole
#: 32-byte sectors
BLOCK_CAP_BYTES = 224
BLOCK_CAP_WORDS = BLOCK_CAP_BYTES // 4
#: blocks per step of the plain E2 (bounds its int64 temporaries)
PLAIN_CHUNK_BLOCKS = 1 << 16


# ---------------------------------------------------------------------------
# Tables: packed (code<<5 | len) entries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedTables:
    ac512: np.ndarray   # (512,) int32: [cls*256 + sym] -> code<<5|len
    dc64: np.ndarray    # (64,)  int32: [cls*32 + cat]  -> code<<5|len
    zrl: np.ndarray     # (2, 2) int32: [cls] -> (code, len)
    eob: np.ndarray     # (2, 2) int32: [cls] -> (code, len)


def build_packed_tables(huff: dict) -> PackedTables:
    ac512 = np.zeros(512, np.int32)
    dc64 = np.zeros(64, np.int32)
    zrl = np.zeros((2, 2), np.int32)
    eob = np.zeros((2, 2), np.int32)
    for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE):
        c = int(ct)
        dc: HuffmanTable = huff[(ct, HuffmanType.DC)]
        ac: HuffmanTable = huff[(ct, HuffmanType.AC)]
        ac512[c * 256:(c + 1) * 256] = \
            (ac.ehufco.astype(np.int64) << 5 | ac.ehufsi).astype(np.int32)
        dc64[c * 32:c * 32 + 16] = \
            (dc.ehufco[:16].astype(np.int64) << 5 | dc.ehufsi[:16]).astype(np.int32)
        zrl[c] = (int(ac.ehufco[0xF0]), int(ac.ehufsi[0xF0]))
        eob[c] = (int(ac.ehufco[0x00]), int(ac.ehufsi[0x00]))
    return PackedTables(ac512, dc64, zrl, eob)


# ---------------------------------------------------------------------------
# Segment geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegGeometry:
    """Per-plan int32 tensors of the entropy stage, on one device."""

    dc_pred: torch.Tensor    # (NB,) scan index of the DC predecessor, -1 none
    block_cls: torch.Tensor  # (NB,) 0 luma / 1 chroma
    seg_start: torch.Tensor  # (S,) first block of each segment
    seg_count: torch.Tensor  # (S,) blocks in each segment
    rst: torch.Tensor        # (S,) RST marker byte 0xD0..0xD7
    has_rst: torch.Tensor    # (S,) 1 unless the segment ends its scan
    cap_out: int             # bytes of one segment's output row


def segment_out_capacity(max_seg_blocks: int) -> int:
    """Worst-case bytes of one segment's output row: every byte stuffed,
    plus the two-byte marker, rounded up to 16."""
    cap = 2 * max_seg_blocks * BLOCK_CAP_BYTES + 2
    return -(-cap // 16) * 16


def build_seg_geometry(plan: CoderPlan, device) -> SegGeometry:
    g = build_enc_geometry(plan)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    return SegGeometry(
        dc_pred=t(g.dc_pred_idx), block_cls=t(g.block_cls),
        seg_start=t(g.seg_block_start), seg_count=t(g.seg_block_count),
        rst=t(g.seg_rst_marker), has_rst=t(g.seg_has_rst),
        cap_out=segment_out_capacity(int(plan.max_seg_block_count)))


def _check(tensors: dict, device) -> None:
    for name, (t, shape, dtype) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# E2: per-block bit strings
# ---------------------------------------------------------------------------

def huffman_blocks(coeff: torch.Tensor, dc_pred: torch.Tensor,
                   block_cls: torch.Tensor, ac512: torch.Tensor,
                   dc64: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(NB, 64) int32 zig-zag coefficients in scan order -> (words (NB,
    BLOCK_CAP_WORDS) int32 holding each block's bit string MSB first,
    bits (NB,) int32). Words past a block's ``ceil(bits/32)`` are
    unspecified."""
    NB = coeff.shape[0]
    _check({"coeff": (coeff, (NB, 64), torch.int32),
            "dc_pred": (dc_pred, (NB,), torch.int32),
            "block_cls": (block_cls, (NB,), torch.int32),
            "ac512": (ac512, (512,), torch.int32),
            "dc64": (dc64, (64,), torch.int32)}, coeff.device)
    if coeff.device.type == "cpu":
        return huffman_blocks_plain(coeff, dc_pred, block_cls, ac512, dc64)
    if coeff.device.type != "cuda":
        raise ValueError(f"unsupported device {coeff.device}")
    if coeff.data_ptr() % 8:
        raise ValueError("coeff must be 8-byte aligned (the kernel loads "
                         "coefficient pairs)")
    words = torch.empty((NB, BLOCK_CAP_WORDS), dtype=torch.int32,
                        device=coeff.device)
    bits = torch.empty((NB,), dtype=torch.int32, device=coeff.device)
    _build.launch(
        "gj_huffman_blocks", coeff.device, coeff.data_ptr(), NB,
        dc_pred.data_ptr(), block_cls.data_ptr(), ac512.data_ptr(),
        dc64.data_ptr(), BLOCK_CAP_WORDS, words.data_ptr(), bits.data_ptr())
    huffman_blocks.launches += 1
    return words, bits


huffman_blocks.launches = 0


def _bit_length(a: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values (JPEG category)."""
    n = torch.zeros_like(a)
    for s in (16, 8, 4, 2, 1):
        big = a >= (1 << s)
        n = n + big * s
        a = torch.where(big, a >> s, a)
    return n + (a > 0)


def _value_bits(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v + (1 << cat) - 1) & ((1 << cat) - 1)


def _low_bits(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The low ``n`` bits of ``v`` (what a field of length ``n`` keeps;
    Annex K codes already fit their lengths)."""
    return v & ((1 << n) - 1)


def _scatter_bits(words: torch.Tensor, row: torch.Tensor, vals: torch.Tensor,
                  lens: torch.Tensor, offs: torch.Tensor) -> None:
    """OR MSB-first fields of at most 32 bits into big-endian 32-bit words
    held in int64 ``words`` (rows, n_words), in place. Fields are
    disjoint, so adding is OR-ing."""
    keep = lens > 0
    row, vals, lens, offs = row[keep], vals[keep], lens[keep], offs[keep]
    if row.numel() == 0:
        return
    n_words = words.shape[1]
    w = row * n_words + (offs >> 5)
    sh = 32 - (offs & 31) - lens                     # in [-31, 32]
    lo = torch.where(sh >= 0, vals << sh.clamp(min=0), vals >> (-sh).clamp(min=0))
    hi = torch.where(sh < 0, (vals << (32 + sh).clamp(0, 32)) & 0xFFFFFFFF, 0)
    flat = words.view(-1)
    flat.index_add_(0, w, lo)
    spill = sh < 0
    flat.index_add_(0, w[spill] + 1, hi[spill])


def _or_window(words: torch.Tensor, row: torch.Tensor, vals: torch.Tensor,
               lens: torch.Tensor, offs: torch.Tensor) -> None:
    """OR fields into int64 ``words`` (rows, n_words) in place by K12's
    window formula (``ablate_stage1.py`` ``kernel_body``): a field at
    offset o goes into word ``o >> 5`` shifted left by ``s0 = 32 - o % 32
    - len``, or, when ``s0 < 0``, right by ``min(-s0, 31)`` with the spill
    shifted left by ``max(32 + s0, 0)`` into the next word; nothing is cut
    to the field's length and words past a row are dropped. For fields
    that fit their lengths this is :func:`_scatter_bits`."""
    keep = lens > 0
    row, vals, lens, offs = row[keep], vals[keep], lens[keep], offs[keep]
    n_words = words.shape[1]
    j = offs >> 5
    s0 = 32 - (offs & 31) - lens
    lo = torch.where(s0 >= 0, (vals << s0.clamp(min=0)) & 0xFFFFFFFF,
                     vals >> (-s0).clamp(0, 31))
    hi = torch.where(s0 < 0, (vals << (32 + s0).clamp(min=0)) & 0xFFFFFFFF,
                     0)
    flat = words.view(-1)
    for w, part in ((j, lo), (j + 1, hi)):
        on = (w < n_words) & (part != 0)
        idx, part = row[on] * n_words + w[on], part[on]
        for b in range(32):     # OR as "any field sets bit b"
            hit = torch.zeros_like(flat).index_add_(0, idx, (part >> b) & 1)
            flat |= (hit > 0).to(torch.int64) << b


def _to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns -> int32 of the same bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def huffman_blocks_plain(coeff: torch.Tensor, dc_pred: torch.Tensor,
                         block_cls: torch.Tensor, ac512: torch.Tensor,
                         dc64: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`huffman_blocks`: DC differences
    through ``dc_pred``, then :func:`_walk_plain`. Words past a block's
    string are zero."""
    dc = coeff[:, 0].to(torch.int64)
    pred = dc_pred.to(torch.int64)
    diff = dc - torch.where(pred < 0, 0, dc[pred.clamp(min=0)])
    return _walk_plain(coeff, diff, block_cls, torch.ones_like(block_cls),
                       ac512, dc64, BLOCK_CAP_WORDS)


def _walk_plain(coeff: torch.Tensor, diff: torch.Tensor,
                block_cls: torch.Tensor, valid: torch.Tensor,
                ac512: torch.Tensor, dc64: torch.Tensor,
                cap_words: int, window: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every block's bit string as the golden coder writes it
    (``golden.encode_block``), with the DC difference ``diff`` given:
    symbols as arrays, offsets by cumsum and one scatter of bit fields,
    :data:`PLAIN_CHUNK_BLOCKS` blocks at a time. The DC code is looked up
    at ``min(cat, 15)``, as K12 does (no DC difference of 8-bit samples
    comes near). Returns (words (NB, cap_words) int32, the first
    ``cap_words`` words of each string with zeros past it, bits (NB,)
    int32 full lengths); a block with ``valid == 0`` has none.

    ``window`` is E12's ``lookups`` mode: the DC and AC symbols' entries
    are ``sym * 3 + cls`` (``sym = cat`` for the DC), fields are not cut
    to their lengths, and :func:`_or_window` places them."""
    dev = coeff.device
    NB = coeff.shape[0]
    c64 = coeff.to(torch.int64)
    diff = diff.to(torch.int64)
    cls = block_cls.to(torch.int64)
    on = valid.to(torch.int64) != 0
    ac_t = ac512.to(torch.int64)
    dc_t = dc64.to(torch.int64)
    keep = cap_words if window else min(cap_words, BLOCK_CAP_WORDS)
    place = _or_window if window else _scatter_bits
    cut = (lambda v, n: v) if window else _low_bits
    words = torch.zeros((NB, cap_words), dtype=torch.int64, device=dev)
    bits = torch.zeros((NB,), dtype=torch.int64, device=dev)
    k = torch.arange(1, 64, device=dev)
    for lo in range(0, NB, PLAIN_CHUNK_BLOCKS):
        hi = min(NB, lo + PLAIN_CHUNK_BLOCKS)
        n = hi - lo
        cl = cls[lo:hi]
        d = diff[lo:hi]
        live = on[lo:hi]
        cat = _bit_length(d.abs())
        e = cat * 3 + cl if window else dc_t[cl * 32 + cat.clamp(max=15)]
        dc_len = torch.where(live, (e & 31) + cat, 0)
        dc_val = cut(((e >> 5) << cat) | _value_bits(d, cat), dc_len)

        ac = c64[lo:hi, 1:]
        nz = (ac != 0) & live[:, None]
        prev_incl = torch.cummax(torch.where(nz, k, 0), dim=1).values
        prev = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                          prev_incl[:, :-1]], dim=1)
        run = k - prev - 1
        r16 = torch.where(nz, run >> 4, 0)
        cat_ac = torch.where(nz, _bit_length(ac.abs()), 0)
        sym = ((run & 15) << 4) | cat_ac
        e = sym * 3 + cl[:, None] if window else ac_t[cl[:, None] * 256 + sym]
        sym_len = torch.where(nz, (e & 31) + cat_ac, 0)
        sym_val = cut(((e >> 5) << cat_ac) | _value_bits(ac, cat_ac), sym_len)
        zrl = ac_t[cl * 256 + 0xF0]
        zrl_len = (zrl & 31)[:, None]
        zrl_code = _low_bits(zrl >> 5, zrl & 31)
        eob = ac_t[cl * 256]
        eob_len = torch.where((ac[:, -1] == 0) & live, eob & 31, 0)

        # bit offsets: DC, then per AC position its ZRLs and its symbol,
        # then the EOB
        len_pos = torch.cat([dc_len[:, None], r16 * zrl_len + sym_len,
                             eob_len[:, None]], dim=1)            # (n, 65)
        csum = torch.cumsum(len_pos, dim=1)
        off = csum - len_pos
        bits[lo:hi] = csum[:, -1]

        part = torch.zeros((n, keep if window else BLOCK_CAP_WORDS),
                           dtype=torch.int64, device=dev)
        local = torch.arange(n, device=dev)
        place(part, local, dc_val, dc_len, off[:, 0])
        place(part, local[:, None].expand(n, 63), sym_val, sym_len,
              off[:, 1:64] + r16 * zrl_len)
        place(part, local, _low_bits(eob >> 5, eob_len), eob_len,
              off[:, 64])
        for j in range(3):     # at most three ZRLs precede one symbol
            place(part, local[:, None].expand(n, 63),
                  zrl_code[:, None].expand(n, 63),
                  torch.where(r16 > j, zrl_len, 0),
                  off[:, 1:64] + j * zrl_len)
        words[lo:hi, :keep] = part[:, :keep]
    return _to_int32_words(words), bits.to(torch.int32)


#: zero runs before a nonzero coefficient in :func:`envelope_blocks`: one
#: under, at and over each ZRL threshold, three ZRLs, the longest run
ENVELOPE_RUNS = (15, 16, 17, 31, 32, 48, 62)


def envelope_huffman_spec(zrl16: bool) -> dict:
    """(bits, values) per (component type, Huffman type) for E2's
    envelope: Annex K, or with the AC symbol 0xF0 (ZRL) moved to the end
    of the values, which gives it one of the 16-bit codes."""
    out = {}
    for key, bits in DEFAULT_HUFFMAN_BITS.items():
        values = list(DEFAULT_HUFFMAN_VALUES[key])
        if zrl16 and key[1] == HuffmanType.AC:
            values.remove(0xF0)
            values.append(0xF0)
        out[key] = (bits, values)
    return out


def envelope_blocks(rng: np.random.Generator) -> np.ndarray:
    """(N, 64) int32 zig-zag blocks that reach every chunk shape of E2's
    walk: each run of :data:`ENVELOPE_RUNS` after the DC, after
    coefficient 1 (before a 1023) and ending at 63 (no EOB, after a
    2047); a lone 63; all-zero AC (DC and EOB only); every AC nonzero;
    |v| up to 2047; sparse random blocks. The DC alternates between -1024
    and 1023, differences of +-2047 along one DC chain."""
    rows = []
    for run in ENVELOPE_RUNS:
        r = np.zeros(64, np.int32)
        r[1 + run] = -3
        rows.append(r)
        r = np.zeros(64, np.int32)
        r[1] = 5
        if 2 + run < 64:
            r[2 + run] = 1023
        rows.append(r)
        r = np.zeros(64, np.int32)
        r[63 - run] = 2047
        r[63] = -1
        rows.append(r)
    r = np.zeros(64, np.int32)
    r[63] = -1023
    rows.append(r)
    rows.append(np.zeros(64, np.int32))
    full = rng.integers(-1023, 1024, 64).astype(np.int32)
    full[full == 0] = 1
    rows.append(full)
    rows.append(rng.integers(-2047, 2048, 64).astype(np.int32))
    for density in (0.02, 0.1, 0.4):
        rows.append(np.where(rng.random(64) < density,
                             rng.integers(-1023, 1024, 64), 0)
                    .astype(np.int32))
    blocks = np.stack(rows)
    blocks[:, 0] = np.where(np.arange(len(rows)) % 2, 1023, -1024)
    return blocks


# ---------------------------------------------------------------------------
# E12: DCT + quantisation + per-block bit strings, fused
# ---------------------------------------------------------------------------

#: E12's stop modes, in the order of the ``stop`` template argument of
#: ``csrc/dct_huffman_blocks.cu``; the modes of ``scripts/
#: ablate_stage1.py`` that a fused DCT and walk has. ``io`` loads and
#: stores only, ``passthru`` writes pixels, ``dctonly`` the DCT with no
#: divisor, ``dct`` the quotients, ``dctmul`` multiplies by the divisor in
#: place of the division, ``synth`` stops after the categories and value
#: bits, ``lookups`` walks with symbol codes from arithmetic in place of
#: the tables, ``full`` is E12. Each writes what the script's mode writes
#: (the source's header says what that is).
STOP_MODES = ("io", "passthru", "dctonly", "dct", "dctmul", "synth",
              "lookups", "full")
#: values the script's pair-row modes write per pair row (words of both
#: blocks at W = 4)
PAIR_VALUES = 8
#: ``io``: every block writes pixel 0 and the diff of the first block of
#: its group of this many blocks (the script's io at a tile of 64)
IO_GROUP_BLOCKS = 64
#: E12's launch (``csrc/dct_huffman_blocks.cu``): strips of 32 blocks, 256
#: threads a CTA, at most 6 CTAs an SM of the H100's 132
E12_STRIP_BLOCKS, E12_THREADS, E12_MAX_CTAS = 32, 256, 132 * 6


def dct_huffman_grid(n_blocks: int) -> tuple[int, int]:
    """(CTAs, threads) of one :func:`dct_huffman_blocks` launch."""
    return (min(-(-n_blocks // E12_STRIP_BLOCKS), E12_MAX_CTAS),
            E12_THREADS)


#: ``dct`` tensors already held equal to ``dct_zigzag_operator()``'s ->
#: their version counter at the check
_OPERATOR_CHECKED = WeakIdKeyDictionary()


def _check_operator(dct: torch.Tensor) -> None:
    """Raise ValueError unless ``dct`` holds ``tables.dct_zigzag_operator()``
    in float32: E12's kernel computes that product in separable form and
    reads no ``dct``. A tensor is compared once (one sync on the card) and
    again only after an in-place change."""
    if _OPERATOR_CHECKED.get(dct) == dct._version:
        return
    want = torch.as_tensor(dct_zigzag_operator()[0].astype(np.float32),
                           device=dct.device)
    if not torch.equal(dct, want):
        raise ValueError("dct must be tables.dct_zigzag_operator() in "
                         "float32 (E12 computes that product in separable "
                         "form)")
    _OPERATOR_CHECKED[dct] = dct._version


def dct_huffman_blocks(blocks: torch.Tensor, diff: torch.Tensor,
                       block_cls: torch.Tensor, valid: torch.Tensor,
                       qsel: torch.Tensor, qdiv: torch.Tensor,
                       dct: torch.Tensor, bias: torch.Tensor,
                       ac512: torch.Tensor, dc64: torch.Tensor,
                       cap_words: int, stop: str = "full"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(NB, 64) uint8 blocks in row-major pixel order -> (words (NB,
    cap_words) int32, bits (NB,) int32).

    Per block: ``q = rint((x @ dct - bias) / qdiv[qsel])`` in float32 by
    E1's separable passes and E1p's arithmetic (the same quotients as
    :func:`dct.fdct_quant_planes` on the same blocks and divisors; ``dct``
    must be ``tables.dct_zigzag_operator()`` in float32, ValueError
    otherwise), then the block's bit string as E2 writes it, with the DC
    difference ``diff`` given instead of found through a predecessor, an
    EOB when ``q[63] == 0``, and no string for a block with ``valid == 0``
    (``bits`` 0). ``words`` holds the first ``cap_words`` words of the
    string MSB first (words past ``ceil(min(bits, 32 * cap_words) / 32)``
    are unspecified), ``bits`` the full length: ``cap_words = W`` is K12's
    contract, truncation included, and ``cap_words = BLOCK_CAP_WORDS`` is
    E2's layout, which E3 takes. ``qsel`` values lie below
    ``qdiv.shape[0]``. ``stop`` picks one of :data:`STOP_MODES`; their
    launches are counted apart in ``dct_huffman_blocks.launches``."""
    NB = blocks.shape[0]
    n_q = qdiv.shape[0] if qdiv.dim() == 2 else 0
    if stop not in STOP_MODES:
        raise ValueError(f"stop must be one of {STOP_MODES}, got {stop!r}")
    if cap_words < 1 or n_q < 1:
        raise ValueError(f"cap_words {cap_words} and qdiv rows {n_q} must "
                         "be positive")
    _check({"blocks": (blocks, (NB, 64), torch.uint8),
            "diff": (diff, (NB,), torch.int32),
            "block_cls": (block_cls, (NB,), torch.int32),
            "valid": (valid, (NB,), torch.int32),
            "qsel": (qsel, (NB,), torch.int32),
            "qdiv": (qdiv, (n_q, 64), torch.float32),
            "dct": (dct, (64, 64), torch.float32),
            "bias": (bias, (64,), torch.float32),
            "ac512": (ac512, (512,), torch.int32),
            "dc64": (dc64, (64,), torch.int32)}, blocks.device)
    _check_operator(dct)
    args = (blocks, diff, block_cls, valid, qsel, qdiv, dct, bias, ac512,
            dc64, cap_words, stop)
    if blocks.device.type == "cpu":
        return dct_huffman_blocks_plain(*args)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    words = torch.empty((NB, cap_words), dtype=torch.int32,
                        device=blocks.device)
    bits = torch.empty((NB,), dtype=torch.int32, device=blocks.device)
    _build.launch(
        "gj_dct_huffman_blocks", blocks.device, blocks.data_ptr(), NB,
        diff.data_ptr(), block_cls.data_ptr(), valid.data_ptr(),
        qsel.data_ptr(), qdiv.data_ptr(), bias.data_ptr(), ac512.data_ptr(),
        dc64.data_ptr(), cap_words, STOP_MODES.index(stop),
        words.data_ptr(), bits.data_ptr())
    dct_huffman_blocks.launches[stop] += 1
    return words, bits


dct_huffman_blocks.launches = dict.fromkeys(STOP_MODES, 0)


def dct_huffman_blocks_plain(blocks: torch.Tensor, diff: torch.Tensor,
                             block_cls: torch.Tensor, valid: torch.Tensor,
                             qsel: torch.Tensor, qdiv: torch.Tensor,
                             dct: torch.Tensor, bias: torch.Tensor,
                             ac512: torch.Tensor, dc64: torch.Tensor,
                             cap_words: int, stop: str = "full"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`dct_huffman_blocks`: the dense
    float32 matmul (K12's definition), ``torch.round``, then
    :func:`_walk_plain` (``lookups``: its window form), or the stop mode's
    values. Words past a string are zero. Its values may differ from the
    kernel's (E1's separable order) by one where the float64 value lies
    within twice the float32 bound of a rounding edge (``ops/dct.py``)."""
    from .dct import fdct_blocks_plain, quantize_plain
    dev = blocks.device
    if stop == "io":
        g = torch.arange(blocks.shape[0], device=dev)
        g = g - g % IO_GROUP_BLOCKS
        px = blocks[g, 0].to(torch.int32)[:, None]
        return px.expand(-1, cap_words).contiguous(), diff[g]
    if stop == "passthru":
        return _pair_rows(blocks.to(torch.int64), None, cap_words)
    y = fdct_blocks_plain(blocks, dct, bias)
    qd = qdiv[qsel.to(torch.int64)]
    if stop == "dctonly":
        return _pair_rows(y.to(torch.int64), None, cap_words)
    if stop == "dctmul":
        return _pair_rows(torch.round(y * qd).to(torch.int64), None,
                          cap_words)
    return e12_from_quotients(quantize_plain(y, qd), diff, block_cls, valid,
                              ac512, dc64, cap_words, stop)


def e12_from_quotients(q: torch.Tensor, diff: torch.Tensor,
                       block_cls: torch.Tensor, valid: torch.Tensor,
                       ac512: torch.Tensor, dc64: torch.Tensor,
                       cap_words: int, stop: str = "full"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """What :func:`dct_huffman_blocks` writes in the ``dct``, ``synth``,
    ``lookups`` or ``full`` mode, from given (NB, 64) zig-zag quotients
    ``q`` (the plain version's own, or the kernel's: E1p's on the same
    blocks): given equal quotients, those modes are exact."""
    if stop == "dct":
        return _pair_rows(q.to(torch.int64), None, cap_words)
    if stop == "synth":
        v = torch.cat([diff[:, None], q[:, 1:]], dim=1).to(torch.int64)
        cat = _bit_length(v.abs())
        return _pair_rows(_value_bits(v, cat) + cat, cat, cap_words)
    if stop not in ("lookups", "full"):
        raise ValueError(f"no {stop!r} output from quotients")
    return _walk_plain(q, diff, block_cls, valid, ac512, dc64, cap_words,
                       window=stop == "lookups")


def _pair_rows(vals: torch.Tensor, bit_vals: torch.Tensor | None,
               cap_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair-row modes' output from (NB, 64) int64 values per block:
    with e = b & ~1 and h = b & 1, word w of block b is ``vals[e, h *
    cap_words + w]`` (0 from index :data:`PAIR_VALUES` on) and its bits
    ``bit_vals[e, h]`` (``bit_vals`` defaults to ``vals``)."""
    dev = vals.device
    b = torch.arange(vals.shape[0], device=dev)
    e, h = b - (b & 1), b & 1
    j = h[:, None] * cap_words + torch.arange(cap_words, device=dev)
    words = torch.where(j < PAIR_VALUES,
                        vals[e[:, None], j.clamp(max=PAIR_VALUES - 1)], 0)
    bit_vals = vals if bit_vals is None else bit_vals
    return (_to_int32_words(words & 0xFFFFFFFF),
            bit_vals[e, h].to(torch.int32))


def from_pair_rows(pb2: np.ndarray, diff2: np.ndarray, cls2: np.ndarray,
                   valid2: np.ndarray, qidx: np.ndarray,
                   q2tab: np.ndarray) -> dict:
    """K12's operands (``entropy_v2.block_chunks_dct_pallas``: two blocks
    per row, block 2i in the left half and 2i+1 in the right, a row's
    divisors as one ``q2tab`` row) -> E12's, as NumPy arrays: ``blocks``,
    ``diff``, ``block_cls``, ``valid``, ``qsel`` and ``qdiv``. Block 2i
    takes the left half of row ``qidx[i]`` (``qdiv`` row ``2 qidx[i]``),
    block 2i+1 the right half (``2 qidx[i] + 1``)."""
    def flat(a, dtype, width=None):
        a = np.ascontiguousarray(a, dtype)
        return a.reshape(-1) if width is None else a.reshape(-1, width)

    qi = 2 * flat(qidx, np.int32, 1)
    return {"blocks": flat(pb2, np.uint8, 64),
            "diff": flat(diff2, np.int32), "block_cls": flat(cls2, np.int32),
            "valid": flat(valid2, np.int32),
            "qsel": flat(np.concatenate([qi, qi + 1], axis=1), np.int32),
            "qdiv": flat(q2tab, np.float32, 64)}


# ---------------------------------------------------------------------------
# E3: per-segment merge, stuffing, RST
# ---------------------------------------------------------------------------

#: blocks per segment and bit lengths per block in
#: :func:`envelope_segments`: under, at and over one and two warp rounds of
#: 32 blocks, and under, at and over a byte and a word, up to a full row
ENVELOPE_SEG_BLOCKS = (1, 31, 32, 33, 64, 100)
ENVELOPE_BLOCK_BITS = (1, 7, 8, 9, 31, 32, 33, BLOCK_CAP_BYTES * 8)


def envelope_segments(rng: np.random.Generator):
    """E3's envelope: ``(words, bits, seg_start, seg_count, rst, has_rst,
    cap_out)`` as NumPy int32 arrays and the row capacity, with segments
    of every count of :data:`ENVELOPE_SEG_BLOCKS` (random lengths from
    :data:`ENVELOPE_BLOCK_BITS`), one of 33 blocks for each length (bit
    totals that are a multiple of 8 and others), two adjacent segments
    of the longest count whose blocks are all-ones full rows (every byte
    stuffed: they fill their rows to the worst case
    :func:`segment_out_capacity` sizes) and one that mixes all-ones
    strings of every length with random ones. String bits are random
    (all-ones where said); the bits of a row past its string are random
    too, since E2 leaves them unwritten. Markers cycle 0xD0..0xD7; the
    last segment has none."""
    cap_bits = BLOCK_CAP_WORDS * 32
    lengths = np.asarray(ENVELOPE_BLOCK_BITS)
    n_max = max(ENVELOPE_SEG_BLOCKS)
    segs = [(rng.choice(lengths, n), False) for n in ENVELOPE_SEG_BLOCKS]
    segs += [(np.full(33, n), False) for n in ENVELOPE_BLOCK_BITS]
    segs += [(np.full(n_max, cap_bits), True)] * 2
    mixed = np.resize(lengths, 64)
    segs.append((mixed, np.arange(64) % 2 == 0))
    bits = np.concatenate([b for b, _ in segs]).astype(np.int32)
    ones = np.concatenate([np.broadcast_to(o, b.shape) for b, o in segs])
    words = rng.integers(0, 1 << 32, (bits.size, BLOCK_CAP_WORDS),
                         dtype=np.uint64)
    bit_idx = np.arange(cap_bits).reshape(BLOCK_CAP_WORDS, 32)
    in_string = bit_idx[None] < bits[:, None, None]
    weight = np.uint64(1) << (31 - np.arange(32, dtype=np.uint64))
    all_ones = (in_string * weight).sum(-1, dtype=np.uint64)
    words = np.where(ones[:, None], words | all_ones, words)
    count = np.array([b.size for b, _ in segs], np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    S = count.size
    rst = (0xD0 + np.arange(S) % 8).astype(np.int32)
    has_rst = (np.arange(S) < S - 1).astype(np.int32)
    return (words.astype(np.uint32).view(np.int32), bits, start, count, rst,
            has_rst, segment_out_capacity(n_max))


def merge_stuff(words: torch.Tensor, bits: torch.Tensor, seg_start: torch.Tensor,
                seg_count: torch.Tensor, rst: torch.Tensor,
                has_rst: torch.Tensor, cap_out: int):
    """Per-block strings -> per-segment stuffed bytes with RST markers.

    Returns (out (S, cap_out) uint8, out_len, seg_bits, n_ff), each (S,)
    int32: the bytes of segment s are ``out[s, :out_len[s]]`` (RST
    included); the rest of a row is unspecified."""
    NB, S = bits.shape[0], seg_start.shape[0]
    _check({"words": (words, (NB, BLOCK_CAP_WORDS), torch.int32),
            "bits": (bits, (NB,), torch.int32),
            "seg_start": (seg_start, (S,), torch.int32),
            "seg_count": (seg_count, (S,), torch.int32),
            "rst": (rst, (S,), torch.int32),
            "has_rst": (has_rst, (S,), torch.int32)}, bits.device)
    if bits.device.type == "cpu":
        return merge_stuff_plain(words, bits, seg_start, seg_count, rst,
                                 has_rst, cap_out)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    dev = bits.device
    out = torch.empty((S, cap_out), dtype=torch.uint8, device=dev)
    out_len, seg_bits, n_ff = (
        torch.empty((S,), dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(
        "gj_merge_stuff", dev, words.data_ptr(), bits.data_ptr(),
        BLOCK_CAP_WORDS, seg_start.data_ptr(), seg_count.data_ptr(),
        rst.data_ptr(), has_rst.data_ptr(), S, cap_out, out.data_ptr(),
        out_len.data_ptr(), seg_bits.data_ptr(), n_ff.data_ptr())
    merge_stuff.launches += 1
    return out, out_len, seg_bits, n_ff


merge_stuff.launches = 0


def merge_stuff_plain(words: torch.Tensor, bits: torch.Tensor,
                      seg_start: torch.Tensor, seg_count: torch.Tensor,
                      rst: torch.Tensor, has_rst: torch.Tensor, cap_out: int):
    """Plain torch version of :func:`merge_stuff`: exclusive cumsum of the
    block bit lengths, one scatter of every used word into segment words,
    then the JAX reference's array stuffing (``huffman_encode_kernel``
    step 5). The segments must cover the blocks in order, as a plan's do.
    Bytes past ``out_len`` are zero."""
    dev = bits.device
    S = seg_start.shape[0]
    b64 = bits.to(torch.int64)
    seg_of_block = torch.repeat_interleave(
        torch.arange(S, device=dev), seg_count.to(torch.int64))
    gpref = torch.cumsum(b64, 0) - b64
    in_seg = gpref - gpref[seg_start.to(torch.int64)][seg_of_block]
    seg_bits = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
        0, seg_of_block, b64)
    pad = (-seg_bits) & 7
    seg_len = (seg_bits + pad) >> 3
    n_words = int(((seg_len.max() + 3) >> 2).item()) + 1 if S else 1
    seg_words = torch.zeros((S, n_words), dtype=torch.int64, device=dev)

    # every used word of every block, as a field of up to 32 bits
    w_used = int(((b64.max() + 31) >> 5).item()) if b64.numel() else 0
    i = torch.arange(w_used, device=dev)
    left = b64[:, None] - 32 * i                                 # (NB, w)
    take = left.clamp(0, 32)
    w = words[:, :w_used].to(torch.int64) & 0xFFFFFFFF
    vals = w >> (32 - take).clamp(max=31)
    vals = torch.where(take == 0, 0, vals)
    row = seg_of_block[:, None].expand_as(take)
    _scatter_bits(seg_words, row, vals, take, in_seg[:, None] + 32 * i)
    # 1-bit padding to the byte boundary (T.81 F.1.2.3)
    _scatter_bits(seg_words, torch.arange(S, device=dev), (1 << pad) - 1,
                  pad, seg_bits)

    by = torch.stack([(seg_words >> s) & 0xFF for s in (24, 16, 8, 0)],
                     dim=-1).reshape(S, 4 * n_words)
    idx = torch.arange(4 * n_words, device=dev)[None, :]
    valid = idx < seg_len[:, None]
    is_ff = (by == 0xFF) & valid
    ff = is_ff.to(torch.int64)
    stuff_pref = torch.cumsum(ff, dim=1) - ff
    n_ff = ff.sum(dim=1)
    out = torch.zeros((S, cap_out), dtype=torch.uint8, device=dev)
    pos = (torch.arange(S, device=dev)[:, None] * cap_out + idx + stuff_pref)
    out.view(-1)[pos[valid]] = by[valid].to(torch.uint8)
    stuffed = seg_len + n_ff
    hr = has_rst.to(torch.int64) > 0
    base = torch.arange(S, device=dev) * cap_out + stuffed
    out.view(-1)[base[hr]] = 0xFF
    out.view(-1)[base[hr] + 1] = rst.to(torch.int64)[hr].to(torch.uint8)
    out_len = stuffed + 2 * hr.to(torch.int64)
    return (out, out_len.to(torch.int32), seg_bits.to(torch.int32),
            n_ff.to(torch.int32))
