// D3 postprocess_planes: crop and replicate the MCU-padded u8 component
// planes to full resolution, apply the integer colour transform of any
// colour pair and pack the raw frame in any of the 8 pixel formats.
//
// Replaces the XLA postprocess (`gpujpeg_tpu/ops/preprocess.py:173`,
// crop + `repeat` upsampling + `colorspace.transform` + `pack_raw`) of the
// JAX reference's plan tail (`jax_pipeline._decode_device_v2`, the non-px
// branch), after K4 or K5 and the XLA IDCT. It is E0 (preprocess.cu) run
// backwards.
//
// Input: the planes of the plan's components, concatenated in component
// order, each (data_height, data_width) row-major (what D2p writes). Per
// plane (byte offset, data width, rows, columns, ry, rx): full-resolution
// pixel (y, x) of component c is plane_c[y / ry][x / rx], with
// ry = ceil(H / rows), which the crop to (rows, columns) keeps in range.
// Output: the raw frame, `pack_raw` byte for byte: a missing channel of
// an interleaved 4:4:4 format is 0 (255 for P012A without a 4th
// component), UYVY takes U and V of the even pixel of each pair, and
// planar 4:2:2/4:2:0 outputs select the pixel (min(r*ry, H-1),
// min(c*rx, W-1)).
//
// What bounds it: bytes. Each output byte costs a few integer operations
// (the colour transform of its pixel); the planes are read once through
// the cache and the frame written once (at 8K 4:2:0 to I420, 49.8 MB each
// way). One thread per output pixel for the interleaved formats (per pixel
// pair for UYVY, a 4-byte word), one per output byte for the planar ones;
// neighbouring threads take neighbouring pixels. All index math is 32-bit:
// the wrapper checks that every size is below 2**31.
//
// Arithmetic (colorspace.py, exact): inverse r = (c - base) * 256 / 255
// truncated toward zero (C division), clamp((m.r + 128) >> 8); forward
// r = c + (c == 255), clamp(((m.r + 128) >> 8) + base); a pair of two
// non-RGB spaces goes through RGB with the clamp between. A 4th channel
// passes through; fewer than 3 channels take no transform.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PixelFormat values (types.py)
constexpr int kU8 = 0, kP012 = 1, kP1020 = 3, kP012Z = 6, kP012A = 7;
constexpr int kOutCols = 6;  // OutGeometry.comp
constexpr int kDstCols = 5;  // OutGeometry.dst
constexpr int kConsts = 26;  // colorspace.PAIR_CONSTS

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// The C channels of full-resolution pixel (y, x), transformed.
__device__ __forceinline__ void sample(const uint8_t* __restrict__ planes,
                                       const int* comp, int C, const int* xf,
                                       int y, int x, int v[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = 0;
    if (c < C) {
      const int* cp = comp + c * kOutCols;
      v[c] = planes[cp[0] + (y / cp[4]) * cp[1] + x / cp[5]];
    }
  }
  if (C < 3) return;
  if (xf[0]) {  // inverse: colour space -> RGB
    int r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = (v[k] - xf[10 + k]) * 256 / 255;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = clamp255((xf[1 + 3 * k] * r[0] + xf[2 + 3 * k] * r[1] +
                       xf[3 + 3 * k] * r[2] + 128) >> 8);
  }
  if (xf[13]) {  // forward: RGB -> colour space
    int r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = v[k] + (v[k] == 255);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = clamp255(((xf[14 + 3 * k] * r[0] + xf[15 + 3 * k] * r[1] +
                        xf[16 + 3 * k] * r[2] + 128) >> 8) +
                      xf[23 + k]);
  }
}

__global__ void postprocess_planes_kernel(
    const uint8_t* __restrict__ planes, int fmt, int H, int W,
    const int* __restrict__ comp, int C, const int* __restrict__ dst,
    const int* __restrict__ xf, uint8_t* __restrict__ out, int n_items) {
  __shared__ int s_comp[4 * kOutCols], s_dst[3 * kDstCols], s_xf[kConsts];
  for (int i = threadIdx.x; i < C * kOutCols; i += blockDim.x)
    s_comp[i] = comp[i];
  for (int i = threadIdx.x; i < 3 * kDstCols; i += blockDim.x)
    s_dst[i] = dst[i];
  for (int i = threadIdx.x; i < kConsts; i += blockDim.x) s_xf[i] = xf[i];
  __syncthreads();

  const bool planar = fmt != kU8 && fmt != kP012 && fmt != kP1020 &&
                      fmt != kP012Z && fmt != kP012A;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += gridDim.x * blockDim.x) {
    int v[4];
    if (planar) {  // one output byte: plane k, row r, column c
      int k = 2;
      while (k > 0 && i < s_dst[k * kDstCols]) --k;
      const int* dp = s_dst + k * kDstCols;
      const int local = i - dp[0];
      const int r = local / dp[1], c = local - r * dp[1];
      sample(planes, s_comp, C, s_xf, min(r * dp[4], H - 1),
             min(c * dp[3], W - 1), v);
      out[i] = (uint8_t)v[k];
    } else if (fmt == kP1020) {  // one pixel pair: U Y V Y
      const int half = (W + 1) >> 1;
      const int y = i / half, x = 2 * (i - y * half);
      uint8_t* o = out + 2 * (y * W + x);
      sample(planes, s_comp, C, s_xf, y, x, v);
      o[0] = (uint8_t)v[1];
      o[1] = (uint8_t)v[0];
      if (x + 1 < W) {
        o[2] = (uint8_t)v[2];
        sample(planes, s_comp, C, s_xf, y, x + 1, v);
        o[3] = (uint8_t)v[0];
      }
    } else {  // one pixel
      const int y = i / W, x = i - y * W;
      sample(planes, s_comp, C, s_xf, y, x, v);
      if (fmt == kU8) {
        out[i] = (uint8_t)v[0];
      } else if (fmt == kP012) {
#pragma unroll
        for (int k = 0; k < 3; ++k) out[3 * i + k] = (uint8_t)(k < C ? v[k] : 0);
      } else {  // P012Z, P012A
        const int fill = (fmt == kP012A && C < 4) ? 255 : 0;
        const int n = (fmt == kP012A && C >= 4) ? 4 : min(C, 3);
        uchar4 o;
        o.x = (uint8_t)(0 < n ? v[0] : fill);
        o.y = (uint8_t)(1 < n ? v[1] : fill);
        o.z = (uint8_t)(2 < n ? v[2] : fill);
        o.w = (uint8_t)(3 < n ? v[3] : fill);
        reinterpret_cast<uchar4*>(out)[i] = o;
      }
    }
  }
}

}  // namespace

extern "C" int gj_postprocess_planes(const void* planes, int fmt, int H,
                                     int W, const void* comp, int C,
                                     const void* dst, const void* xf,
                                     void* out, int raw_bytes, void* stream) {
  if (C < 1 || C > 4 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  int n_items;
  if (fmt == kU8 || fmt == kP012 || fmt == kP012Z || fmt == kP012A)
    n_items = H * W;
  else if (fmt == kP1020)
    n_items = H * ((W + 1) >> 1);
  else
    n_items = raw_bytes;
  const int threads = 256;
  long long ctas = ((long long)n_items + threads - 1) / threads;
  if (ctas > 132 * 32) ctas = 132 * 32;  // grid-stride beyond ~32 CTAs/SM
  if (ctas < 1) ctas = 1;
  postprocess_planes_kernel<<<(unsigned)ctas, threads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)planes, fmt, H, W, (const int*)comp, C,
      (const int*)dst, (const int*)xf, (uint8_t*)out, n_items);
  return (int)cudaGetLastError();
}
