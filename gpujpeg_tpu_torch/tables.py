"""JPEG quantization and Huffman tables.

Behavioral parity with the reference table generator
(reference: src/gpujpeg_table.c) and ITU-T T.81 Annex K defaults:

* default quant tables stored in zig-zag order (gpujpeg_table.c:36-56),
* quality scaling ``s = q<50 ? 5000/q : 200-2q``; ``v=(s*t+50)/100`` clamped
  to 1..255 (gpujpeg_table.c:84-99),
* Annex-K default Huffman bits/values (gpujpeg_table.c:190-256),
* encoder code/size generation per T.81 Figures C.1-C.3
  (gpujpeg_table.c:265-306),
* decoder mincode/maxcode/valptr per F.15/F.16 plus lookahead LUTs
  (gpujpeg_table.c:384-449).

All tables are NumPy arrays; device code uploads them as needed.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading

import numpy as np

from .types import ComponentType, HuffmanType

# ---------------------------------------------------------------------------
# Zig-zag order
# ---------------------------------------------------------------------------

#: Natural (raster) position of the i-th zig-zag coefficient
#: (T.81 Figure A.6; reference: gpujpeg_table.h:73-84 ``gpujpeg_order_natural``).
ZIGZAG_TO_NATURAL = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

#: Zig-zag position of the i-th natural coefficient (inverse permutation).
NATURAL_TO_ZIGZAG = np.empty(64, dtype=np.int32)
NATURAL_TO_ZIGZAG[ZIGZAG_TO_NATURAL] = np.arange(64, dtype=np.int32)

# ---------------------------------------------------------------------------
# Quantization tables
# ---------------------------------------------------------------------------

#: Default luminance quant table, zig-zag order (gpujpeg_table.c:36-45).
DEFAULT_QUANT_LUMA_ZZ = np.array([
    16, 11, 12, 14, 12, 10, 16, 14,
    13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37,
    29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68,
    87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113,
    121, 112, 100, 120, 92, 101, 103, 99,
], dtype=np.int32)

#: Default chrominance quant table, zig-zag order (gpujpeg_table.c:47-56).
DEFAULT_QUANT_CHROMA_ZZ = np.array([
    17, 18, 18, 24, 21, 24, 47, 26,
    26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def quant_table_zz(comp_type: ComponentType, quality: int) -> np.ndarray:
    """Quality-scaled quant table in zig-zag order, uint8 semantics.

    Reference: gpujpeg_table_quantization_apply_quality
    (gpujpeg_table.c:84-99)."""
    base = (DEFAULT_QUANT_LUMA_ZZ if comp_type == ComponentType.LUMINANCE
            else DEFAULT_QUANT_CHROMA_ZZ)
    quality = min(max(int(quality), 1), 100)
    s = (5000 // quality) if quality < 50 else (200 - 2 * quality)
    table = (s * base + 50) // 100
    return np.clip(table, 1, 255).astype(np.int32)


def quant_table_natural(comp_type: ComponentType, quality: int) -> np.ndarray:
    """Quality-scaled quant table in natural (raster) order."""
    zz = quant_table_zz(comp_type, quality)
    nat = np.empty(64, dtype=np.int32)
    nat[ZIGZAG_TO_NATURAL] = zz
    return nat


# ---------------------------------------------------------------------------
# Huffman tables (Annex K defaults)
# ---------------------------------------------------------------------------

#: bits[i] = number of codes of length i+1 (16 entries), plus value list.
#: (reference: gpujpeg_table.c:190-256; identical to T.81 Annex K.3.)
DEFAULT_HUFFMAN_BITS = {
    (ComponentType.LUMINANCE, HuffmanType.DC):
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    (ComponentType.CHROMINANCE, HuffmanType.DC):
        [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    (ComponentType.LUMINANCE, HuffmanType.AC):
        [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    (ComponentType.CHROMINANCE, HuffmanType.AC):
        [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
}

_DC_VALUES = list(range(12))

_AC_LUMA_VALUES = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]

_AC_CHROMA_VALUES = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]

DEFAULT_HUFFMAN_VALUES = {
    (ComponentType.LUMINANCE, HuffmanType.DC): _DC_VALUES,
    (ComponentType.CHROMINANCE, HuffmanType.DC): _DC_VALUES,
    (ComponentType.LUMINANCE, HuffmanType.AC): _AC_LUMA_VALUES,
    (ComponentType.CHROMINANCE, HuffmanType.AC): _AC_CHROMA_VALUES,
}


@dataclasses.dataclass(frozen=True)
class HuffmanTable:
    """A Huffman table with encoder and decoder derived forms.

    Encoder forms per T.81 C.1-C.3 (reference: gpujpeg_table.c:265-306);
    decoder forms per F.15/F.16 (reference: gpujpeg_table.c:384-449).
    """

    bits: np.ndarray      # (16,) uint8: count of codes per length 1..16
    values: np.ndarray    # (n,)  uint8: symbols in code order ("huffval")
    # encoder: code/size per symbol value (256 entries; size 0 = absent)
    ehufco: np.ndarray    # (256,) uint32
    ehufsi: np.ndarray    # (256,) int32
    # decoder: serial-decode tables
    mincode: np.ndarray   # (17,) int32, index by code length
    maxcode: np.ndarray   # (18,) int32 (maxcode[17] = sentinel)
    valptr: np.ndarray    # (17,) int32
    # decoder: 16-bit lookahead LUT: peek -> packed (symbol<<8 | nbits);
    # nbits==0 means invalid code.
    lut16: np.ndarray     # (65536,) int32

    @property
    def n_values(self) -> int:
        return int(self.values.shape[0])


def build_huffman_table(bits, values) -> HuffmanTable:
    bits = np.asarray(bits, dtype=np.int32)
    values = np.asarray(values, dtype=np.int32)
    assert bits.shape == (16,)

    # T.81 C.1: generate huffsize list.
    huffsize = np.repeat(np.arange(1, 17, dtype=np.int32), bits)
    n = huffsize.shape[0]
    assert n == values.shape[0], (n, values.shape)

    # T.81 C.2: generate codes.
    huffcode = np.zeros(n, dtype=np.uint32)
    code = 0
    si = huffsize[0] if n else 0
    k = 0
    while k < n:
        while k < n and huffsize[k] == si:
            huffcode[k] = code
            code += 1
            k += 1
        code <<= 1
        si += 1

    # T.81 C.3: order codes by symbol value.
    ehufco = np.zeros(256, dtype=np.uint32)
    ehufsi = np.zeros(256, dtype=np.int32)
    ehufco[values] = huffcode
    ehufsi[values] = huffsize

    # T.81 F.15: decoder mincode/maxcode/valptr.
    mincode = np.zeros(17, dtype=np.int64)
    maxcode = np.full(18, -1, dtype=np.int64)
    valptr = np.zeros(17, dtype=np.int64)
    p = 0
    for l in range(1, 17):
        if bits[l - 1]:
            valptr[l] = p
            mincode[l] = huffcode[p]
            p += bits[l - 1]
            maxcode[l] = huffcode[p - 1]
        else:
            maxcode[l] = -1
    # Sentinel that terminates the length scan even on corrupt data
    # (reference: gpujpeg_table.c:423-424).
    maxcode[17] = 0xFFFFF

    # 16-bit lookahead LUT: for every 16-bit window, the first code's
    # symbol and length (reference decoder builds the same "full" table,
    # gpujpeg_huffman_gpu_decoder.cu:552-617).
    lut16 = np.zeros(65536, dtype=np.int32)
    for i in range(n):
        l = int(huffsize[i])
        c = int(huffcode[i])
        lo = c << (16 - l)
        hi = lo + (1 << (16 - l))
        lut16[lo:hi] = (int(values[i]) << 8) | l

    return HuffmanTable(
        bits=bits.astype(np.uint8),
        values=values.astype(np.uint8),
        ehufco=ehufco,
        ehufsi=ehufsi,
        mincode=mincode.astype(np.int64),
        maxcode=maxcode.astype(np.int64),
        valptr=valptr.astype(np.int64),
        lut16=lut16,
    )


#: distinct DHT tables whose derived forms :func:`dht_huffman_table` keeps,
#: the least recently used dropped first: about 265 KB each, mostly ``lut16``
DHT_TABLES = 32

_dht_tables: collections.OrderedDict = collections.OrderedDict()
_dht_lock = threading.Lock()


def dht_huffman_table(bits: bytes, values: bytes) -> tuple[HuffmanTable, bool]:
    """The table of one DHT table, from its 16 ``bits`` bytes and its
    ``values`` bytes: (the table, True where this call derived it). A
    stream's tables repeat from stream to stream (Annex K's, a video's
    every frame), so each distinct table is derived once by
    :func:`build_huffman_table` and then shared, its arrays read-only,
    while it is among the :data:`DHT_TABLES` used last. The key is every
    byte the derivation reads, so a shared table is what a rebuild would
    give."""
    key = bits + values          # bits is always 16 bytes: no ambiguity
    with _dht_lock:
        table = _dht_tables.get(key)
        if table is not None:
            _dht_tables.move_to_end(key)
            return table, False
    table = build_huffman_table(np.frombuffer(bits, np.uint8),
                                np.frombuffer(values, np.uint8))
    for field in dataclasses.fields(table):
        getattr(table, field.name).setflags(write=False)
    with _dht_lock:
        _dht_tables[key] = table
        if len(_dht_tables) > DHT_TABLES:
            _dht_tables.popitem(last=False)
    return table, True


def clear_dht_tables() -> None:
    """Forget every table :func:`dht_huffman_table` keeps."""
    with _dht_lock:
        _dht_tables.clear()


@functools.lru_cache(maxsize=None)
def default_huffman_table(comp_type: ComponentType, huff_type: HuffmanType) -> HuffmanTable:
    key = (ComponentType(comp_type), HuffmanType(huff_type))
    return build_huffman_table(DEFAULT_HUFFMAN_BITS[key], DEFAULT_HUFFMAN_VALUES[key])


def encode_tables(quality: int) -> tuple[dict, dict]:
    """The encoder's tables at ``quality``: (table index -> zig-zag (64,)
    quant table, luminance 0 and chrominance 1; (ComponentType,
    HuffmanType) -> the Annex K Huffman table)."""
    quant_zz = {
        0: quant_table_zz(ComponentType.LUMINANCE, quality),
        1: quant_table_zz(ComponentType.CHROMINANCE, quality),
    }
    huff = {
        (ct, ht): default_huffman_table(ct, ht)
        for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)
        for ht in (HuffmanType.DC, HuffmanType.AC)
    }
    return quant_zz, huff


# ---------------------------------------------------------------------------
# DCT matrices (built here so both the NumPy golden path and the JAX path
# derive from one definition)
# ---------------------------------------------------------------------------

def dct8_matrix() -> np.ndarray:
    """8-point DCT-II matrix D (float64) such that ``Y = D @ X @ D.T`` is the
    exact JPEG forward DCT of an 8x8 block (T.81 A.3.3 normalization)."""
    j = np.arange(8)
    u = np.arange(8)[:, None]
    c = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * j + 1) * u * np.pi / 16.0)


def fdct_quant_matrix(quant_zz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fused forward-DCT + quantization operator.

    Returns ``(M, bias)`` (float64) such that for a flattened 8x8 block
    ``x`` (natural raster order, uint8 values 0..255)::

        coeff_zz = round(x @ M - bias)

    gives the quantized coefficients **in zig-zag order**. The level shift
    of -128 is folded into ``bias`` and quantization (division by the
    quality-scaled table) is folded into the matrix columns, mirroring how
    the reference pre-divides its DCT table (gpujpeg_table.c:112-120) —
    but mapped to an MXU-friendly single (64,64) matmul instead of the
    AAN warp butterfly.
    """
    D = dct8_matrix()
    M = np.kron(D, D)  # (64 out coeffs natural, 64 in pixels)
    quant_nat = np.empty(64, dtype=np.float64)
    quant_nat[ZIGZAG_TO_NATURAL] = quant_zz.astype(np.float64)
    Mq = M / quant_nat[:, None]           # fold quantization
    Mq_zz = Mq[ZIGZAG_TO_NATURAL, :]      # rows permuted -> zig-zag output
    bias = 128.0 * Mq_zz.sum(axis=1)      # fold level shift
    return Mq_zz.T.copy(), bias           # x(row) @ M(64,64) layout


def dct_zigzag_operator() -> tuple[np.ndarray, np.ndarray]:
    """Quantization-independent forward-DCT operator.

    Returns ``(D64, bias)`` (float64) such that ``y_zz = x @ D64 - bias``
    is the *unquantized* 2-D DCT of the flattened block in zig-zag order
    with the -128 level shift folded into ``bias``. Quantized coefficients
    are then ``round(y_zz / q_zz)``. Splitting quantization out of the
    matrix lets one MXU operator serve blocks of mixed component classes
    (the chunked pipeline mixes luma and chroma blocks in one matmul)."""
    D = dct8_matrix()
    M = np.kron(D, D)
    M_zz = M[ZIGZAG_TO_NATURAL, :]
    bias = 128.0 * M_zz.sum(axis=1)
    return M_zz.T.copy(), bias


def idct_dequant_matrix(quant_zz: np.ndarray) -> np.ndarray:
    """Fused dequantization + inverse-DCT operator.

    Returns ``W`` (float64) such that for zig-zag quantized coefficients
    ``c`` of one block::

        pixels = clamp(round(c @ W + 128), 0, 255)

    where pixels are the flattened 8x8 block in natural raster order.
    """
    D = dct8_matrix()
    M = np.kron(D, D)                         # natural coeff -> pixel basis
    Minv = M.T                                # orthonormal inverse
    W = Minv[:, ZIGZAG_TO_NATURAL]            # accept zig-zag coeff order
    W = W * quant_zz.astype(np.float64)[None, :]  # fold dequant into columns
    return W.T.copy()                         # c(row) @ W(64,64)


@functools.lru_cache(maxsize=16)
def idct_operator_f32(quant_zz_key: tuple) -> np.ndarray:
    """float32 :func:`idct_dequant_matrix` of a zig-zag quant table given
    as a tuple (rows: zig-zag coefficient k, columns: natural pixel p)."""
    quant_zz = np.array(quant_zz_key, dtype=np.int32)
    return idct_dequant_matrix(quant_zz).astype(np.float32)


# ---------------------------------------------------------------------------
# Device tensors of the tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """The encoder's tables as tensors on one device."""

    quant_zz: dict          # table index -> (64,) int32, zig-zag order
    qdiv: "torch.Tensor"    # (n_q, 64) float32 divisors, max(quant, 1)
    huff: dict              # (ComponentType, HuffmanType) -> (2, 256) int32
                            # rows: ehufco, ehufsi
    ac512: "torch.Tensor"   # (512,) int32 packed AC codes (PackedTables)
    dc64: "torch.Tensor"    # (64,) int32 packed DC codes (PackedTables)
    dct: "torch.Tensor"     # (64, 64) float32 zig-zag DCT operator
    bias: "torch.Tensor"    # (64,) float32 level-shift bias


def device_tables(quant_zz: dict, huff: dict, device) -> DeviceTables:
    """Turn NumPy tables into the port's tensors on ``device``.

    ``quant_zz`` maps a table index to its zig-zag (64,) table and
    ``huff`` maps (ComponentType, HuffmanType) to a table with
    ``ehufco``/``ehufsi`` — the shape of :func:`encode_tables` and of the
    JAX reference's ``Encoder._tables``, whose integer enum keys compare equal to these."""
    import torch

    from .ops.entropy import build_packed_tables

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    n_q = max(max(quant_zz) + 1, 2)
    qdiv = np.ones((n_q, 64), np.float32)
    for qi, q in quant_zz.items():
        qdiv[qi] = np.maximum(np.asarray(q, np.float32), 1.0)
    packed = build_packed_tables(huff)
    D64, bias64 = dct_zigzag_operator()
    return DeviceTables(
        quant_zz={qi: i32(q) for qi, q in quant_zz.items()},
        qdiv=torch.as_tensor(qdiv, device=device),
        huff={key: i32(np.stack([t.ehufco, t.ehufsi]))
              for key, t in huff.items()},
        ac512=i32(packed.ac512),
        dc64=i32(packed.dc64),
        dct=torch.as_tensor(D64.astype(np.float32), device=device),
        bias=torch.as_tensor(bias64.astype(np.float32), device=device),
    )


@dataclasses.dataclass(frozen=True)
class DecodeTables:
    """The decoder's tables as tensors on one device (all int32 but
    ``wq`` and ``quant``)."""

    wide: "torch.Tensor"     # (n_slots, 2**WIDE_BITS) sym<<5 | len, 0 = miss
    maxcode: "torch.Tensor"  # (n_slots, 18) scaled to a 16-bit peek
    delta: "torch.Tensor"    # (n_slots, 17) valptr - mincode per length
    huffval: "torch.Tensor"  # (n_slots, 256)
    dc_slot: "torch.Tensor"  # (4,) component -> DC table slot
    ac_slot: "torch.Tensor"  # (4,) component -> AC table slot
    wq: "torch.Tensor"       # (n_q, 64, 64) float32 IDCT operators
    quant: "torch.Tensor"    # (n_q, 64) float32 zig-zag quant tables of wq
    q_of: "torch.Tensor"     # (C,) component -> wq / quant index


def decode_device_tables(dec, wide, dc_slot, ac_slot, qts, q_of,
                         device) -> DecodeTables:
    """Turn NumPy decode tables into the port's tensors on ``device``.

    ``dec`` has the ``maxcode``/``delta``/``huffval`` arrays of
    ``build_dec_tables_v2`` (the port's ``ops.decode.DecTables`` or the
    JAX reference's, which are equal), ``wide`` its
    ``ops.decode.wide_quick_tables`` (D1's first-level table, in place of
    the reference's ``quick``), ``dc_slot``/``ac_slot`` are the
    (4,) slot maps, ``qts`` the unique zig-zag quant tables (tuples of 64
    ints; ``wq`` holds their :func:`idct_operator_f32`, ``quant`` their
    values) and ``q_of`` each component's index into them."""
    import torch

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return DecodeTables(
        wide=i32(wide), maxcode=i32(dec.maxcode), delta=i32(dec.delta),
        huffval=i32(dec.huffval), dc_slot=i32(dc_slot), ac_slot=i32(ac_slot),
        wq=f32(np.stack([idct_operator_f32(tuple(k)) for k in qts])),
        quant=f32(np.asarray(qts, np.float32).reshape(-1, 64)),
        q_of=i32(q_of))
