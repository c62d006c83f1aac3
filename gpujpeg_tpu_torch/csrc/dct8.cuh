// The 8x8 DCT factor, the zig-zag order and the separable passes over a
// padded shared tile, for E1 (fdct_quant.cu), E1p (fdct_quant_planes.cu),
// E12 (dct_huffman_blocks.cu), D2 (idct_rgb.cu) and D2p (idct_planes.cu).
//
// kD8 is `tables.dct8_matrix()` rounded to float32 (held equal to it by
// tests/test_torch_e1_separable.py). It sits in the constant bank, so an
// FMA reads it as an operand. Both tables have internal linkage: each .cu
// compiles on its own and the objects link into one library, so every
// source that includes this header keeps its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// D[u][k] = c(u) cos((2k + 1) u pi / 16), c(0) = 1/sqrt(8), else 1/2
__constant__ float kD8[64] = {
    0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f,
    0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f,
    0.49039263f, 0.4157348f, 0.27778512f, 0.09754516f,
    -0.09754516f, -0.27778512f, -0.4157348f, -0.49039263f,
    0.46193975f, 0.19134171f, -0.19134171f, -0.46193975f,
    -0.46193975f, -0.19134171f, 0.19134171f, 0.46193975f,
    0.4157348f, -0.09754516f, -0.49039263f, -0.27778512f,
    0.27778512f, 0.49039263f, 0.09754516f, -0.4157348f,
    0.35355338f, -0.35355338f, -0.35355338f, 0.35355338f,
    0.35355338f, -0.35355338f, -0.35355338f, 0.35355338f,
    0.27778512f, -0.49039263f, 0.09754516f, 0.4157348f,
    -0.4157348f, -0.09754516f, 0.49039263f, -0.27778512f,
    0.19134171f, -0.46193975f, 0.46193975f, -0.19134171f,
    -0.19134171f, 0.46193975f, -0.46193975f, 0.19134171f,
    0.09754516f, -0.27778512f, 0.4157348f, -0.49039263f,
    0.49039263f, -0.4157348f, 0.27778512f, -0.09754516f};

// zig-zag index -> natural (raster) index
__device__ const uint8_t kZigzagToNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// E1's forward row pass: t[u] = sum_k x[k] D[u][k] for the 8 pixels x of
// one block row, each sum in k order with fmaf from 0, into t[0..7].
__device__ __forceinline__ void fdct8_row(const float (&x)[8], float* t) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(x[k], kD8[u * 8 + k], acc);
    t[u] = acc;
  }
}

// E1's forward column pass, in place on the column t[0], t[kPitch], ...,
// t[7 kPitch] of a row-pass tile (rows kPitch floats apart: 8 in E1's
// and E1p's tiles, 9 in E12's): y[v] = sum_j D[v][j] t[j], in j order
// from 0.
template <int kPitch = 8>
__device__ __forceinline__ void fdct8_col(float* t) {
  float col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col[j] = t[j * kPitch];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(kD8[v * 8 + j], col[j], acc);
    t[v * kPitch] = acc;
  }
}

// D2's inverse column pass, in place on the column t[0], t[8], ..., t[56]
// of a dequantised tile: out[y] = sum_v D[v][y] x[v], split by the
// factor's symmetry into the even-v terms E and the odd-v terms O (each
// by fmaf in index order from 0), out[y] = E + O, out[7 - y] = E - O.
__device__ __forceinline__ void idct8_col(float* t) {
  float x[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) x[v] = t[v * 8];
#pragma unroll
  for (int py = 0; py < 4; ++py) {
    float ev = 0.f, od = 0.f;
#pragma unroll
    for (int v = 0; v < 8; v += 2) {
      ev = fmaf(kD8[v * 8 + py], x[v], ev);
      od = fmaf(kD8[(v + 1) * 8 + py], x[v + 1], od);
    }
    t[py * 8] = __fadd_rn(ev, od);
    t[(7 - py) * 8] = __fsub_rn(ev, od);
  }
}

// D2's inverse row pass of the row t[0..7] (split as the column pass),
// then + 128, rintf (half to even) and a clamp to [0, 255]: the row's 8
// pixels as bytes, pixel 0 in the low byte of .x.
__device__ __forceinline__ uint2 idct8_row_u8(const float* t) {
  float row[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) row[u] = t[u];
  uint32_t lo4 = 0u, hi4 = 0u;
#pragma unroll
  for (int px = 0; px < 4; ++px) {
    float ev = 0.f, od = 0.f;
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      ev = fmaf(row[u], kD8[u * 8 + px], ev);
      od = fmaf(row[u + 1], kD8[(u + 1) * 8 + px], od);
    }
    const float lo = rintf(__fadd_rn(__fadd_rn(ev, od), 128.f));
    const float hi = rintf(__fadd_rn(__fsub_rn(ev, od), 128.f));
    lo4 |= (uint32_t)fminf(fmaxf(lo, 0.f), 255.f) << (8 * px);
    hi4 |= (uint32_t)fminf(fmaxf(hi, 0.f), 255.f) << (8 * (3 - px));
  }
  return make_uint2(lo4, hi4);
}

}  // namespace
