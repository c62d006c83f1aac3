// E1p fdct_quant_planes: blockify + f32 zig-zag DCT + quantisation of the
// component planes that E0 (preprocess.cu) writes, in scan order.
//
// Replaces the DCT+quant half of `entropy_v2.block_chunks_dct_fused` (K6)
// of the JAX reference and its staged path's XLA blockify, scan-order
// gather and DCT matmul (`jax_pipeline.py:209-243`); E2 then does the
// entropy half of K6 and the work of K7.
//
// Input: the u8 planes (any number of components, any sampling), the
// (NB,) scan -> plane block map `plan.block_plane_idx`, per plane (byte
// offset, data width, first plane block, blocks per row) and its divisor
// row. Output: int32 coefficients (NB, 64), zig-zag order, row i the plane
// block block_plane_idx[i]: what E2 reads.
//
// What bounds it: arithmetic, 64 FMAs per coefficient (4096 per block), as
// E1. The design is E1's: thread p of a 64-thread group owns coefficient p
// and holds DCT column p in registers for the whole kernel; the group's
// 8x8 block sits in shared memory, where a warp reads one word per k (a
// broadcast). A group takes one scan-order block at a time and finds its
// plane by a scan of at most 4 first-block offsets.
//
// Numerics: E1's exactly (k-order fmaf from 0, one rounded subtraction of
// the bias, IEEE division `__fdiv_rn`, `rintf` half-to-even), so on 4:4:4
// RGB input E1p on E0's planes equals E1 bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;  // blocks per iteration of a CTA

__global__ void __launch_bounds__(64 * kGroups)
fdct_quant_planes_kernel(const uint8_t* __restrict__ planes,
                         const int* __restrict__ block_plane_idx, int NB,
                         const int* __restrict__ blk,  // (C, 4)
                         int C,
                         const float* __restrict__ qdiv,  // (C, 64)
                         const float* __restrict__ dct,   // (64, 64)
                         const float* __restrict__ bias,  // (64,)
                         int32_t* __restrict__ out) {
  __shared__ float xs[kGroups][64];
  const int p = threadIdx.x & 63;  // pixel index on load, coefficient after
  const int g = threadIdx.x >> 6;

  float d[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) d[k] = dct[k * 64 + p];
  const float b = bias[p];

  for (long long first = (long long)blockIdx.x * kGroups; first < NB;
       first += (long long)gridDim.x * kGroups) {
    const long long i = first + g;
    int c = 0;
    __syncthreads();  // the previous iteration is done with xs
    if (i < NB) {
      const int pb = block_plane_idx[i];
      c = C - 1;
      while (c > 0 && pb < blk[c * 4 + 2]) --c;
      const int* bp = blk + c * 4;
      const int local = pb - bp[2];
      const int by = local / bp[3], bx = local % bp[3];
      xs[g][p] = (float)planes[bp[0] + (long long)(by * 8 + (p >> 3)) * bp[1] +
                               bx * 8 + (p & 7)];
    }
    __syncthreads();
    if (i >= NB) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 64; ++k) acc = fmaf(xs[g][k], d[k], acc);
    const float y = __fsub_rn(acc, b);
    out[i * 64 + p] = (int32_t)rintf(__fdiv_rn(y, qdiv[c * 64 + p]));
  }
}

}  // namespace

extern "C" int gj_fdct_quant_planes(const void* planes,
                                    const void* block_plane_idx, int NB,
                                    const void* blk, int C, const void* qdiv,
                                    const void* dct, const void* bias,
                                    void* out, void* stream) {
  long long ctas = ((long long)NB + kGroups - 1) / kGroups;
  if (ctas > 132 * 16) ctas = 132 * 16;  // grid-stride beyond ~16 CTAs/SM
  if (ctas < 1) ctas = 1;
  fdct_quant_planes_kernel<<<(unsigned)ctas, 64 * kGroups, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)block_plane_idx, NB,
      (const int*)blk, C, (const float*)qdiv, (const float*)dct,
      (const float*)bias, (int32_t*)out);
  return (int)cudaGetLastError();
}
