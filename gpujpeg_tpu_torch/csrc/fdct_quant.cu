// E1 fdct_quant: colour transform + blockify + f32 zig-zag DCT + quantisation.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stages 1-2 (blockify, DCT+quant), together with the XLA words front end
// that fed it (`rgbpack.pack_plane_words`).
//
// Input: raw interleaved RGB bytes (H, W, 3), H and W multiples of 8.
// Output: int32 coefficients (n_blocks, 64), zig-zag order, in scan order:
// component-major raster blocks (non-interleaved) or Y,Cb,Cr per block
// position (interleaved 4:4:4).
//
// What bounds it: arithmetic. Each coefficient is a 64-term dot product
// (64 FMAs), 4096 FMAs per 8x8 block and component; the pixel bytes read
// and coefficient words written are small beside that. The design keeps
// the operand the FMAs stream out of memory: thread p of a 64-thread group
// owns output coefficient p and holds DCT column p in 64 registers for the
// whole kernel, and the group's 8x8 pixel block sits in shared memory,
// where all 32 lanes of a warp read the same word (a broadcast) at each k.
//
// Numerics: the sum runs in k order with explicit IEEE fmaf, the level
// shift is one rounded subtraction, and the quotient is the IEEE
// round-to-nearest division `__fdiv_rn` (no reciprocal multiply) rounded
// half-to-even by `rintf`. A quotient that lies within rounding distance
// of .5 may round differently from a matmul that sums in another order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;  // 8x8 block positions per iteration of a CTA

__global__ void __launch_bounds__(64 * kGroups)
fdct_quant_kernel(const uint8_t* __restrict__ rgb, int H, int W,
                  const float* __restrict__ dct,   // (64, 64) x @ dct
                  const float* __restrict__ bias,  // (64,)
                  const float* __restrict__ qdiv,  // (3, 64) per component
                  const int* __restrict__ xf,      // m9[9], base[3], identity
                  int interleaved, int32_t* __restrict__ out) {
  __shared__ float xs[kGroups][3][64];
  const int p = threadIdx.x & 63;  // pixel index on load, coefficient after
  const int g = threadIdx.x >> 6;

  float d[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) d[k] = dct[k * 64 + p];
  const float b = bias[p];
  const float q0 = qdiv[p], q1 = qdiv[64 + p], q2 = qdiv[128 + p];

  const int identity = xf[12];
  int m[9], base[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = xf[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) base[i] = xf[9 + i];

  const int nbx = W >> 3;
  const long long nblk = (long long)nbx * (H >> 3);
  for (long long first = (long long)blockIdx.x * kGroups; first < nblk;
       first += (long long)gridDim.x * kGroups) {
    const long long blk = first + g;
    __syncthreads();  // the previous iteration is done with xs
    if (blk < nblk) {
      const int by = (int)(blk / nbx), bx = (int)(blk % nbx);
      const uint8_t* px =
          rgb + ((size_t)(by * 8 + (p >> 3)) * W + (bx * 8 + (p & 7))) * 3;
      int c[3] = {px[0], px[1], px[2]};
      if (identity) {
#pragma unroll
        for (int i = 0; i < 3; ++i) xs[g][i][p] = (float)c[i];
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) c[i] += (c[i] == 255);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          int acc = m[3 * i] * c[0] + m[3 * i + 1] * c[1] + m[3 * i + 2] * c[2];
          int v = ((acc + 128) >> 8) + base[i];
          xs[g][i][p] = (float)min(max(v, 0), 255);
        }
      }
    }
    __syncthreads();
    if (blk >= nblk) continue;
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 64; ++k) acc = fmaf(xs[g][comp][k], d[k], acc);
      const float y = __fsub_rn(acc, b);
      const float q = comp == 0 ? q0 : (comp == 1 ? q1 : q2);
      const long long row = interleaved ? blk * 3 + comp : comp * nblk + blk;
      out[row * 64 + p] = (int32_t)rintf(__fdiv_rn(y, q));
    }
  }
}

}  // namespace

extern "C" int gj_fdct_quant(const void* rgb, int H, int W, const void* dct,
                             const void* bias, const void* qdiv,
                             const void* xf, int interleaved, void* out,
                             void* stream) {
  const long long nblk = (long long)(W / 8) * (H / 8);
  long long ctas = (nblk + kGroups - 1) / kGroups;
  if (ctas > 132 * 16) ctas = 132 * 16;  // grid-stride beyond ~16 CTAs/SM
  if (ctas < 1) ctas = 1;
  fdct_quant_kernel<<<(unsigned)ctas, 64 * kGroups, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, H, W, (const float*)dct, (const float*)bias,
      (const float*)qdiv, (const int*)xf, interleaved, (int32_t*)out);
  return (int)cudaGetLastError();
}
