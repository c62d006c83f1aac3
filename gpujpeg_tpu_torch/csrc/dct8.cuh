// The 8x8 DCT factor and the zig-zag order, compiled in, for the separable
// transforms of E1 (fdct_quant.cu) and D2 (idct_rgb.cu).
//
// kD8 is `tables.dct8_matrix()` rounded to float32 (held equal to it by
// tests/test_torch_e1_separable.py). It sits in the constant bank, so an
// FMA reads it as an operand. Both tables have internal linkage: each .cu
// compiles on its own and the objects link into one library, so every
// source that includes this header keeps its own copy.
#pragma once

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

}  // namespace
