// D2p idct_planes: dequantisation + f32 IDCT + unblockify of scan-order
// zig-zag coefficients into the MCU-padded u8 component planes, for any
// plan (any sampling, interleaved or not, 1 to 4 components).
//
// Replaces the XLA plan tail of the JAX reference after K4 (`run_raw`) or
// K5: the scan -> plane gather (`jax_pipeline.py:1156`), and per component
// `dct.dequant_idct_device` and `blocks.blocks_to_plane`
// (`jax_pipeline.py:1158-1184`). D3 (postprocess.cu) then packs the raw
// frame.
//
// Input: coefficients (NB, 64) int32 in scan order (D1's output); `wq`
// (n_q, 64, 64) f32 operators (row: zig-zag k, column: natural pixel p;
// y = x @ W), n_q <= 4; `q_of[C]` each plane's operator; per plane (byte
// offset, data width, first plane block, blocks per row); the (NB,) scan
// -> plane block map `plan.block_plane_idx`. Output: the planes,
// concatenated in component order, each (data_height, data_width) row-major:
// E0's layout, what D3 reads.
//
// Arithmetic: D2's exactly (idct_rgb.cu): y_p = sum_k x_k * W[k][p] in k
// order with fmaf from 0, then + 128 (`__fadd_rn`, one rounding), rintf
// (half to even) and a clamp to [0, 255]. So on 4:4:4 input, D2p followed
// by D3 to RGB equals D2 bit for bit.
//
// What bounds it: arithmetic, 64 FMAs per pixel (3.2 G at 8K 4:2:0),
// beside 200 MB of coefficient reads and 50 MB of pixel writes. The design
// is D2's: the operators sit in shared memory; a 64-thread group stages kPos
// scan-order blocks of coefficients (as f32) in shared memory with, per
// block, its plane position and operator (found by a scan of at most 4
// first-block offsets), and thread p computes pixel p of all kPos blocks.
// When the kPos blocks share one operator (all but the blocks where the
// component changes), each operator word it loads feeds kPos FMAs; else each
// block reads its own. Either way the sum is the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPos = 4;     // blocks per 64-thread group
constexpr int kGroups = 2;  // groups per CTA
constexpr int kThreads = 64 * kGroups;

__global__ void __launch_bounds__(kThreads)
idct_planes_kernel(const int32_t* __restrict__ coeff, int NB,
                   const float* __restrict__ wq, int n_q,
                   const int32_t* __restrict__ q_of,
                   const int32_t* __restrict__ blk,  // (C, 4)
                   int C, const int32_t* __restrict__ block_plane_idx,
                   uint8_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // n_q * 4096
  float(*xs)[kPos][64] =
      reinterpret_cast<float(*)[kPos][64]>(ws + n_q * 4096);
  __shared__ int s_base[kGroups][kPos];  // plane byte of the block's (0, 0)
  __shared__ int s_dw[kGroups][kPos];    // its plane's data width
  __shared__ int s_q[kGroups][kPos];     // its operator; -1 past NB
  for (int i = threadIdx.x; i < n_q * 4096; i += blockDim.x) ws[i] = wq[i];

  const int p = threadIdx.x & 63;
  const int g = threadIdx.x >> 6;
  const int py = p >> 3, px = p & 7;
  for (long long first = (long long)blockIdx.x * (kGroups * kPos);
       first < NB; first += (long long)gridDim.x * (kGroups * kPos)) {
    __syncthreads();  // the operators are loaded; xs is free again
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const long long i = first + g * kPos + j;
      xs[g][j][p] = i < NB ? (float)coeff[i * 64 + p] : 0.f;
    }
    if (p < kPos) {
      const long long i = first + g * kPos + p;
      int q = -1, base = 0, dw = 0;
      if (i < NB) {
        const int pb = block_plane_idx[i];
        int c = C - 1;
        while (c > 0 && pb < blk[c * 4 + 2]) --c;
        const int* bp = blk + c * 4;
        const int local = pb - bp[2];
        const int by = local / bp[3], bx = local - by * bp[3];
        dw = bp[1];
        base = bp[0] + by * 8 * dw + bx * 8;
        q = q_of[c];
      }
      s_base[g][p] = base;
      s_dw[g][p] = dw;
      s_q[g][p] = q;
    }
    __syncthreads();
    const int q0 = s_q[g][0];
    if (q0 < 0) continue;  // the whole group lies past NB

    float acc[kPos];
#pragma unroll
    for (int j = 0; j < kPos; ++j) acc[j] = 0.f;
    bool uniform = true;
#pragma unroll
    for (int j = 1; j < kPos; ++j) uniform &= s_q[g][j] == q0 || s_q[g][j] < 0;
    if (uniform) {
      const float* w = ws + q0 * 4096 + p;
#pragma unroll 4
      for (int k = 0; k < 64; k += 4) {
        const float w0 = w[(k + 0) * 64], w1 = w[(k + 1) * 64];
        const float w2 = w[(k + 2) * 64], w3 = w[(k + 3) * 64];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(&xs[g][j][k]);
          acc[j] = fmaf(x.x, w0, acc[j]);
          acc[j] = fmaf(x.y, w1, acc[j]);
          acc[j] = fmaf(x.z, w2, acc[j]);
          acc[j] = fmaf(x.w, w3, acc[j]);
        }
      }
    } else {
      const float* w[kPos];
#pragma unroll
      for (int j = 0; j < kPos; ++j) w[j] = ws + max(s_q[g][j], 0) * 4096 + p;
#pragma unroll 4
      for (int k = 0; k < 64; k += 4) {
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(&xs[g][j][k]);
          acc[j] = fmaf(x.x, w[j][(k + 0) * 64], acc[j]);
          acc[j] = fmaf(x.y, w[j][(k + 1) * 64], acc[j]);
          acc[j] = fmaf(x.z, w[j][(k + 2) * 64], acc[j]);
          acc[j] = fmaf(x.w, w[j][(k + 3) * 64], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      if (s_q[g][j] < 0) continue;
      const float v = rintf(__fadd_rn(acc[j], 128.f));
      out[s_base[g][j] + py * s_dw[g][j] + px] =
          (uint8_t)fminf(fmaxf(v, 0.f), 255.f);
    }
  }
}

}  // namespace

extern "C" int gj_idct_planes(const void* coeff, int NB, const void* wq,
                              int n_q, const void* q_of, const void* blk,
                              int C, const void* block_plane_idx, void* out,
                              void* stream) {
  if (n_q < 1 || n_q > 4 || C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)n_q * 4096 + (size_t)kGroups * kPos * 64);
  cudaError_t e = cudaFuncSetAttribute(
      idct_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  long long ctas = ((long long)NB + kGroups * kPos - 1) / (kGroups * kPos);
  if (ctas > 132 * 16) ctas = 132 * 16;  // grid-stride beyond ~16 CTAs/SM
  if (ctas > 0)
    idct_planes_kernel<<<(unsigned)ctas, kThreads, smem,
                         (cudaStream_t)stream>>>(
        (const int32_t*)coeff, NB, (const float*)wq, n_q,
        (const int32_t*)q_of, (const int32_t*)blk, C,
        (const int32_t*)block_plane_idx, (uint8_t*)out);
  return (int)cudaGetLastError();
}
