"""Host (NumPy) reference codec — correctness oracle and CPU fallback.

Plays the role of the reference's CPU paths (gpujpeg_huffman_cpu_encoder.c,
gpujpeg_huffman_cpu_decoder.c, gpujpeg_dct_cpu.c): a simple, obviously
correct implementation that the device kernels are validated against and
that serves as the fallback for tiny segment counts
(reference: gpujpeg_decoder.c:238-252).

All coefficients are in **zig-zag order**, matching the device layout.
"""
from __future__ import annotations

import numpy as np

from ..plan import CoderPlan
from ..tables import (
    fdct_quant_matrix,
    HuffmanTable,
    idct_dequant_matrix,
)

# ---------------------------------------------------------------------------
# DCT + quantization (float64 golden)
# ---------------------------------------------------------------------------


def fdct_quant(blocks_u8: np.ndarray, quant_zz: np.ndarray) -> np.ndarray:
    """(N, 64) uint8 pixel blocks -> (N, 64) int32 quantized zig-zag coeffs."""
    M, bias = fdct_quant_matrix(quant_zz)
    y = blocks_u8.astype(np.float64) @ M - bias
    return np.rint(y).astype(np.int32)


def dequant_idct(coeff_zz: np.ndarray, quant_zz: np.ndarray) -> np.ndarray:
    """(N, 64) int coeffs -> (N, 64) uint8 pixel blocks."""
    W = idct_dequant_matrix(quant_zz)
    x = coeff_zz.astype(np.float64) @ W + 128.0
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Huffman entropy coding (serial bit-level golden)
# ---------------------------------------------------------------------------


class BitWriter:
    """T.81 F.1.2 bit emitter with 0xFF byte stuffing
    (reference: gpujpeg_huffman_cpu_encoder.c:72-107)."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.nbits -= 8
            self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        """Pad final byte with 1-bits (T.81 F.1.2.3)."""
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)
        return bytes(self.out)


def _category(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def encode_block(bw: BitWriter, coeff_zz: np.ndarray, dc_pred: int,
                 dc_table: HuffmanTable, ac_table: HuffmanTable) -> int:
    """Encode one block; returns its DC value (the next predictor).
    (reference: gpujpeg_huffman_cpu_encoder.c:109-232)."""
    dc = int(coeff_zz[0])
    diff = dc - dc_pred
    cat = _category(diff)
    bw.put(int(dc_table.ehufco[cat]), int(dc_table.ehufsi[cat]))
    if cat:
        v = diff if diff >= 0 else diff + (1 << cat) - 1
        bw.put(v, cat)

    run = 0
    for k in range(1, 64):
        v = int(coeff_zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bw.put(int(ac_table.ehufco[0xF0]), int(ac_table.ehufsi[0xF0]))
            run -= 16
        cat = _category(v)
        sym = (run << 4) | cat
        bw.put(int(ac_table.ehufco[sym]), int(ac_table.ehufsi[sym]))
        bits = v if v >= 0 else v + (1 << cat) - 1
        bw.put(bits, cat)
        run = 0
    if run > 0:
        bw.put(int(ac_table.ehufco[0x00]), int(ac_table.ehufsi[0x00]))
    return dc


def encode_segments(plan: CoderPlan, coeff_scan: np.ndarray,
                    dc_by_comp: list[HuffmanTable],
                    ac_by_comp: list[HuffmanTable]) -> list[bytes]:
    """Encode all segments; ``coeff_scan`` is (n_blocks, 64) in scan order.
    ``dc_by_comp``/``ac_by_comp`` are indexed by component index. Returns
    the entropy bytes of each segment (stuffed, byte-aligned, without RST
    markers)."""
    out = []
    comps = plan.components
    for s in range(plan.n_segments):
        start = int(plan.seg_block_start[s])
        count = int(plan.seg_block_count[s])
        bw = BitWriter()
        dc_pred = {c.index: 0 for c in comps}
        for b in range(start, start + count):
            ci = int(plan.block_comp[b])
            dc_pred[ci] = encode_block(
                bw, coeff_scan[b], dc_pred[ci],
                dc_by_comp[ci], ac_by_comp[ci])
        out.append(bw.flush())
    return out


class BitReader:
    """Bit reader over stuffed entropy bytes; skips 0x00 after 0xFF
    (reference: gpujpeg_huffman_cpu_decoder.c:75-237)."""

    def __init__(self, data: np.ndarray) -> None:
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self, need: int) -> None:
        while self.nbits < need:
            if self.pos < len(self.data):
                b = int(self.data[self.pos])
                self.pos += 1
                if b == 0xFF and self.pos < len(self.data) and self.data[self.pos] == 0x00:
                    self.pos += 1  # skip stuffed zero
            else:
                b = 0  # fake zeros past the end (corrupt-stream guard)
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1
        return v

    def peek16(self) -> int:
        self._fill(16)
        return (self.acc >> (self.nbits - 16)) & 0xFFFF


def _decode_symbol(br: BitReader, table: HuffmanTable) -> int:
    entry = int(table.lut16[br.peek16()])
    length = entry & 0xFF
    if length == 0:
        # invalid code — corrupt stream; consume one bit to make progress
        br.get(1)
        return 0
    br.get(length)
    return entry >> 8


def _extend(v: int, cat: int) -> int:
    if cat == 0:
        return 0
    return v if v >= (1 << (cat - 1)) else v - (1 << cat) + 1


def decode_block(br: BitReader, out_zz: np.ndarray, dc_pred: int,
                 dc_table: HuffmanTable, ac_table: HuffmanTable) -> int:
    """Decode one block into ``out_zz`` (64,); returns new DC value."""
    cat = _decode_symbol(br, dc_table)
    diff = _extend(br.get(cat), cat) if cat else 0
    dc = dc_pred + diff
    out_zz[0] = dc
    k = 1
    while k < 64:
        sym = _decode_symbol(br, ac_table)
        run, cat = sym >> 4, sym & 0xF
        if cat == 0:
            if run == 15:  # ZRL
                k += 16
                continue
            break  # EOB
        k += run
        if k > 63:
            break  # corrupt guard (sentinel behavior, gpujpeg_table.h:64-83)
        out_zz[k] = _extend(br.get(cat), cat)
        k += 1
    return dc


def decode_segments(plan: CoderPlan, scan_data: list[np.ndarray],
                    segments_by_scan: list[list[tuple[int, int]]],
                    dc_by_comp: list[HuffmanTable],
                    ac_by_comp: list[HuffmanTable]) -> np.ndarray:
    """Decode all segments -> (n_blocks, 64) int32 coeffs in scan order.

    ``scan_data`` / ``segments_by_scan``: per plan-scan, the entropy bytes
    and per-segment offsets as produced by the stream reader.
    ``dc_by_comp``/``ac_by_comp`` are indexed by component index."""
    coeff = np.zeros((plan.n_blocks, 64), dtype=np.int32)
    comps = plan.components
    for s in range(plan.n_segments):
        scan_id = int(plan.seg_scan[s])
        seg_idx = int(plan.seg_scan_index[s])
        data = scan_data[scan_id]
        seg_list = segments_by_scan[scan_id]
        if seg_idx >= len(seg_list):
            continue  # missing segment (corrupt stream) -> zeros
        lo, hi = seg_list[seg_idx]
        br = BitReader(data[lo:hi])
        start = int(plan.seg_block_start[s])
        count = int(plan.seg_block_count[s])
        dc_pred = {c.index: 0 for c in comps}
        for b in range(start, start + count):
            ci = int(plan.block_comp[b])
            dc_pred[ci] = decode_block(
                br, coeff[b], dc_pred[ci],
                dc_by_comp[ci], ac_by_comp[ci])
    return coeff
