// Byte-stream helpers of E0 (preprocess.cu) and D3 (postprocess.cu): word
// loads of a byte span at any alignment, stores of a word run by the
// widest vector its address allows, the divisions by 255 of colorspace.py
// as closed forms, and a division by a small runtime divisor as one
// multiply.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pixio {

// PixelFormat values (types.py)
constexpr int kU8 = 0, kP012 = 1, kP444 = 2, kP1020 = 3, kP422 = 4,
              kP420 = 5, kP012Z = 6, kP012A = 7;
// raw layouts: one byte a pixel, 3 or 4 interleaved, UYVY, three planes
enum Layout { kLU8, kL3, kL4, kLUYVY, kLPlanar };
// which steps of a colour pair apply (a template argument of the kernels)
enum Steps { kNone = 0, kInv = 1, kFwd = 2, kBoth = 3 };
// raw rows an E0 CTA takes, output rows a D3 CTA takes
// (`preprocess.BAND_ROWS`)
constexpr int kBandRows = 8;

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// c * 256 / 255 for c in 0..255 (floor): c, except 256 for 255.
__device__ __forceinline__ int expand255(int c) { return c + (c == 255); }

// expand255(clamp255(t)) for any t.
__device__ __forceinline__ int clamp_expand255(int t) {
  const int c = max(t, 0);
  return c >= 255 ? 256 : c;
}

// (v - base) * 256 / 255 truncated toward zero, for d = v - base in
// -255..255: d, except +-256 for +-255.
__device__ __forceinline__ int unexpand255(int d) {
  return d + (d == 255) - (d == -255);
}

// x / d for 0 <= x < 2**30 and m = ceil(2**31 / d), exact where
// x * (m * d - 2**31) < 2**31 (D3's wrapper checks that for the frame's
// largest row and column: `preprocess.magic_exact`).
__device__ __forceinline__ int div_magic(int x, unsigned m) {
  return (int)__umulhi((unsigned)x << 1, m);
}

// Byte i of a little-endian word run (i known at compile time once
// unrolled).
template <int NW>
__device__ __forceinline__ int byte_of(const uint32_t (&w)[NW], int i) {
  return (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// The 4 * NW bytes at p, any alignment, as words: aligned 4-byte loads
// (every word loaded holds at least one byte of the span) realigned by a
// funnel shift.
template <int NW>
__device__ __forceinline__ void load_span(const uint8_t* p,
                                          uint32_t (&w)[NW]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = (unsigned)(a & 3) * 8;
  uint32_t r[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = __ldg(q + i);
  r[NW] = sh ? __ldg(q + NW) : 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(r[i], r[i + 1], sh);
}

// The 4 * NW bytes of w to p, by 16-, 8- or 4-byte stores where p's
// alignment allows, else byte by byte.
template <int NW>
__device__ __forceinline__ void store_words(uint8_t* p,
                                            const uint32_t (&w)[NW]) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  if (NW % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i + 3 < NW; i += 4)
      reinterpret_cast<uint4*>(p)[i >> 2] =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else if (NW % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i + 1 < NW; i += 2)
      reinterpret_cast<uint2*>(p)[i >> 1] = make_uint2(w[i], w[i + 1]);
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4 * NW; ++i)
      p[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Four byte values (0..255) as one little-endian word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) |
         ((uint32_t)d << 24);
}

// The colour pair of colorspace.pair_consts: (flag, m9, base3) of the
// inverse to RGB, then of the forward from RGB.
struct Pair {
  int inv, mi[9], bi[3], fwd, mf[9], bf[3];
};

// The pair from colorspace.pair_consts' 26 integers.
inline Pair pair_from(const int* c) {
  Pair x;
  x.inv = c[0];
  for (int i = 0; i < 9; ++i) x.mi[i] = c[1 + i];
  for (int i = 0; i < 3; ++i) x.bi[i] = c[10 + i];
  x.fwd = c[13];
  for (int i = 0; i < 9; ++i) x.mf[i] = c[14 + i];
  for (int i = 0; i < 3; ++i) x.bf[i] = c[23 + i];
  return x;
}

}  // namespace pixio
