// D2 idct_rgb: dequantisation + f32 IDCT + inverse colour transform +
// unblockify, from zig-zag coefficients to interleaved RGB bytes.
//
// Replaces the fused tail of `pallas_decode_v3.run_pixels` (K2,
// gpujpeg_tpu/ops/pallas_decode_v3.py:505-541: in-kernel dequant+IDCT and
// the 4-pixel word pack), `pallas_decode.unblockify_bands` (K3,
// gpujpeg_tpu/ops/pallas_decode.py:238) and the XLA
// `rgbpack.interleave_raw_words` after them. Writing each pixel at its plane
// position (row, col) is what K3 computes; no word layout exists here.
//
// Input: coefficients (3 * H/8 * W/8, 64) int32 in scan order (component-
// major, or Y/Cb/Cr per block position when `interleaved`, the two orders E1
// writes); `wq` (n_q, 64, 64) f32 operators (row: zig-zag k, column: natural
// pixel p; y = x @ W); `q_of[3]` each component's operator; `xf[13]` the
// inverse-transform constants (m9, base3, identity flag). Output: (H, W, 3)
// uint8.
//
// Per block position and component: y_p = sum_k x_k * W[k][p], summed in k
// order with fmaf from 0, then + 128 (one rounding), rintf (half to even) and
// a clamp to [0, 255] -- `dct.dequant_idct_device`. Then per pixel the exact
// integer inverse (`colorspace._transform_from`): r = (c - base) * 256 / 255
// with C truncation toward zero, out = clamp((m.r + 128) >> 8, 0, 255) with
// an arithmetic shift.
//
// What bounds it: arithmetic, 64 FMAs per pixel and component (6.4 G at 8K),
// beside 400 MB of coefficient reads and 100 MB of pixel writes. The design:
// the operators sit in shared memory; a 64-thread group stages kPos block
// positions of coefficients (as f32) in shared memory, and thread p computes
// pixel p of all kPos positions at once, so each operator word it loads
// feeds kPos FMAs, and the coefficients come as float4 broadcasts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPos = 4;     // block positions per 64-thread group
constexpr int kGroups = 2;  // groups per CTA
constexpr int kThreads = 64 * kGroups;

__global__ void __launch_bounds__(kThreads)
idct_rgb_kernel(const int32_t* __restrict__ coeff, int H, int W,
                const float* __restrict__ wq, int n_q,
                const int32_t* __restrict__ q_of,
                const int32_t* __restrict__ xf, int interleaved,
                uint8_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);          // n_q * 4096
  float(*xs)[kPos][3][64] =
      reinterpret_cast<float(*)[kPos][3][64]>(ws + n_q * 4096);
  for (int i = threadIdx.x; i < n_q * 4096; i += blockDim.x) ws[i] = wq[i];

  const int p = threadIdx.x & 63;
  const int g = threadIdx.x >> 6;
  const float* wc[3] = {ws + q_of[0] * 4096 + p, ws + q_of[1] * 4096 + p,
                        ws + q_of[2] * 4096 + p};
  const int identity = xf[12];
  int m[9], base[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = xf[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) base[i] = xf[9 + i];

  const int nbx = W >> 3;
  const long long nblk = (long long)nbx * (H >> 3);
  const int py = p >> 3, px = p & 7;
  for (long long first = (long long)blockIdx.x * (kGroups * kPos);
       first < nblk; first += (long long)gridDim.x * (kGroups * kPos)) {
    __syncthreads();  // the operators are loaded; xs is free again
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const long long pos = first + g * kPos + j;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = 0.f;
        if (pos < nblk) {
          const long long row = interleaved ? pos * 3 + c : c * nblk + pos;
          v = (float)coeff[row * 64 + p];
        }
        xs[g][j][c][p] = v;
      }
    }
    __syncthreads();

    int y[kPos][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc[kPos];
#pragma unroll
      for (int j = 0; j < kPos; ++j) acc[j] = 0.f;
      const float* w = wc[c];
#pragma unroll 4
      for (int k = 0; k < 64; k += 4) {
        const float w0 = w[(k + 0) * 64], w1 = w[(k + 1) * 64];
        const float w2 = w[(k + 2) * 64], w3 = w[(k + 3) * 64];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(&xs[g][j][c][k]);
          acc[j] = fmaf(x.x, w0, acc[j]);
          acc[j] = fmaf(x.y, w1, acc[j]);
          acc[j] = fmaf(x.z, w2, acc[j]);
          acc[j] = fmaf(x.w, w3, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPos; ++j) {
        const float v = rintf(__fadd_rn(acc[j], 128.f));
        y[j][c] = (int)fminf(fmaxf(v, 0.f), 255.f);
      }
    }

#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const long long pos = first + g * kPos + j;
      if (pos >= nblk) continue;
      int o[3];
      if (identity) {
#pragma unroll
        for (int i = 0; i < 3; ++i) o[i] = y[j][i];
      } else {
        int r[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) r[i] = ((y[j][i] - base[i]) * 256) / 255;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int a = m[3 * i] * r[0] + m[3 * i + 1] * r[1] +
                        m[3 * i + 2] * r[2] + 128;
          o[i] = min(max(a >> 8, 0), 255);
        }
      }
      const long long by = pos / nbx, bx = pos % nbx;
      uint8_t* dst = out + ((by * 8 + py) * W + bx * 8 + px) * 3;
      dst[0] = (uint8_t)o[0];
      dst[1] = (uint8_t)o[1];
      dst[2] = (uint8_t)o[2];
    }
  }
}

}  // namespace

extern "C" int gj_idct_rgb(const void* coeff, int H, int W, const void* wq,
                           int n_q, const void* q_of, const void* xf,
                           int interleaved, void* out, void* stream) {
  if (n_q < 1 || n_q > 3) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)n_q * 4096 + (size_t)kGroups * kPos * 3 * 64);
  cudaError_t e = cudaFuncSetAttribute(
      idct_rgb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nblk = (long long)(W / 8) * (H / 8);
  long long ctas = (nblk + kGroups * kPos - 1) / (kGroups * kPos);
  if (ctas > 132 * 16) ctas = 132 * 16;  // grid-stride beyond ~16 CTAs/SM
  if (ctas > 0)
    idct_rgb_kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)coeff, H, W, (const float*)wq, n_q,
        (const int32_t*)q_of, (const int32_t*)xf, interleaved,
        (uint8_t*)out);
  return (int)cudaGetLastError();
}
