// The bit reader's chunk load and the symbol step shared by D1
// (huffman_decode.cu) and the lane decoder (huffman_lanes.cu): K2's
// `lookup_sym` over the first-level table and the reference's T.81 F.16
// compares, and the value bits' sign extension.
//
// Tables in shared memory, per slot: `wide` (`decode.wide_quick_tables`,
// kWideBits bits, `sym << 5 | len`, len 0 = miss), `maxcode` (18 per slot,
// compared against the 16-bit peek), `delta` (17), `huffval` (256).
// Internal linkage, as dct8.cuh: each .cu that includes this header keeps
// its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 4;
constexpr int kWideBits = 11;

// Chunk `ch` (words 4 ch .. 4 ch + 3) of rows that start on a 16-byte
// boundary; zero past `row_end` (the reading row's end), and word by word at
// the tensor's last chunk (`total` words).
__device__ __forceinline__ uint4 load_chunk(const uint32_t* __restrict__ rows,
                                            long long ch, long long row_end,
                                            long long total) {
  const long long w0 = ch * 4;
  if (w0 >= row_end) return make_uint4(0u, 0u, 0u, 0u);
  if (w0 + 4 <= total) return __ldg(reinterpret_cast<const uint4*>(rows) + ch);
  uint4 v = make_uint4(rows[w0], 0u, 0u, 0u);
  if (w0 + 1 < total) v.y = rows[w0 + 1];
  if (w0 + 2 < total) v.z = rows[w0 + 2];
  return v;
}

__device__ __forceinline__ int shl1(int n) {  // 1 << n, 0 for n >= 32
  return n >= 32 ? 0 : (int)(1u << n);
}

// (symbol, code length) of the code at the top of `view` in `slot`: a hit
// in `wide`, else s_len = 9 + #(peek16 >= maxcode[l]) over l = 9..16 and
// huffval[clip(code + delta[s_len], 0, 255)]; s_len == 17 is an invalid
// code, symbol 0 of one bit.
__device__ __forceinline__ void lookup_sym(const uint16_t* wide,
                                           const int* maxcode,
                                           const int* delta,
                                           const int* huffval, int slot,
                                           uint32_t view, int& sym, int& ln) {
  const int q = wide[(slot << kWideBits) | (view >> (32 - kWideBits))];
  if (q & 31) {
    sym = q >> 5;
    ln = q & 31;
    return;
  }
  const int peek16 = (int)(view >> 16);
  int len = 9;
#pragma unroll
  for (int l = 9; l <= 16; ++l) len += peek16 >= maxcode[slot * 18 + l];
  if (len == 17) {  // invalid code: symbol 0, one bit
    sym = 0;
    ln = 1;
    return;
  }
  int v = (peek16 >> (16 - len)) + delta[slot * 17 + len];
  v = min(max(v, 0), 255);
  sym = huffval[slot * 256 + v];
  ln = len;
}

// The `cat` value bits after an `ln`-bit code at the top of `view`,
// sign-extended (T.81 F.12); 0 for cat 0.
__device__ __forceinline__ int extend_value(uint32_t view, int ln, int cat) {
  if (cat <= 0) return 0;
  const int sh = min(cat, 16);
  const int vraw = (int)((view << ln) >> (32 - sh));
  return vraw < shl1(cat - 1)
             ? (int)((uint32_t)vraw - (uint32_t)shl1(cat) + 1u)
             : vraw;
}

}  // namespace
