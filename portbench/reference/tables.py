"""Tables of baseline JPEG (ITU-T T.81) as the benchmark's reference uses
them: the zig-zag order, the Annex K quantisation tables scaled by the
IJG quality rule, the Annex K Huffman tables with their encoder and
decoder forms, and the float64 DCT operators.

A frozen copy of the same definitions in ``gpujpeg_tpu_torch/tables.py``
(itself after GPUJPEG's ``gpujpeg_table.c``), kept here so that a change
to the program cannot move the yardstick.
"""
from __future__ import annotations

import functools

import numpy as np

#: natural (raster) position of the i-th zig-zag coefficient (T.81 A.6)
ZIGZAG_TO_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

#: Annex K.1 tables, zig-zag order: luminance, chrominance
QUANT_BASE_ZZ = (
    np.array([16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
              26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
              56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
              95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101,
              103, 99], dtype=np.int64),
    np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47] + [99, 66, 56, 66]
             + [99] * 50, dtype=np.int64),
)


def quant_table_zz(kind: int, quality: int) -> np.ndarray:
    """Quality-scaled table of class ``kind`` (0 luminance, 1
    chrominance), zig-zag order: ``s = 5000 / q`` below 50, else ``200 -
    2q``; ``(s * t + 50) / 100`` clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    s = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((s * QUANT_BASE_ZZ[kind] + 50) // 100, 1, 255)


#: Annex K.3 code counts per length 1..16 and symbols, keyed (class,
#: kind): class 0 DC, 1 AC; kind 0 luminance, 1 chrominance
HUFFMAN_BITS = {
    (0, 0): [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    (0, 1): [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    (1, 0): [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    (1, 1): [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
}
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
HUFFMAN_VALUES = {
    (0, 0): list(range(12)), (0, 1): list(range(12)),
    (1, 0): list(_AC_LUMA), (1, 1): list(_AC_CHROMA),
}


def huffman_codes(bits, values) -> tuple[np.ndarray, np.ndarray]:
    """T.81 C.1-C.3: (code, length) of every symbol value (256 each;
    length 0 where the symbol has no code)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[values[k]] = code
            len_of[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def huffman_lut16(bits, values) -> np.ndarray:
    """For every 16-bit window, ``symbol << 8 | length`` of the code that
    begins it, 0 where no code does."""
    code_of, len_of = huffman_codes(bits, values)
    lut = np.zeros(65536, np.int64)
    for v in values:
        n = int(len_of[v])
        lo = int(code_of[v]) << (16 - n)
        lut[lo:lo + (1 << (16 - n))] = (v << 8) | n
    return lut


@functools.lru_cache(maxsize=None)
def default_huffman(cls: int, kind: int):
    """(bits, values, code_of, len_of) of an Annex K table."""
    bits, values = HUFFMAN_BITS[(cls, kind)], HUFFMAN_VALUES[(cls, kind)]
    return (bits, values) + huffman_codes(bits, values)


def dct8() -> np.ndarray:
    """8-point DCT-II, ``Y = D @ X @ D.T`` the T.81 A.3.3 forward DCT."""
    j = np.arange(8)
    u = np.arange(8)[:, None]
    c = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * j + 1) * u * np.pi / 16.0)


def fdct_operator(quant_zz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(M, bias), float64: for a block's 64 samples ``x`` in raster order,
    ``x @ M - bias`` is its DCT divided by the table, zig-zag order, with
    the level shift of 128 folded into ``bias``."""
    D = dct8()
    K = np.kron(D, D)
    quant_nat = np.empty(64)
    quant_nat[ZIGZAG_TO_NATURAL] = quant_zz
    Mq = (K / quant_nat[:, None])[ZIGZAG_TO_NATURAL, :]
    return Mq.T.copy(), 128.0 * Mq.sum(axis=1)


def idct_operator(quant_zz: np.ndarray) -> np.ndarray:
    """W, float64: for a block's zig-zag coefficients ``c``, ``c @ W +
    128`` are its 64 samples in raster order before rounding."""
    D = dct8()
    K = np.kron(D, D)
    W = K.T[:, ZIGZAG_TO_NATURAL] * quant_zz.astype(np.float64)[None, :]
    return W.T.copy()
