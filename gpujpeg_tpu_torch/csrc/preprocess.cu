// E0 preprocess_planes: unpack any of the 8 raw pixel formats, apply the
// integer colour transform of any colour pair, subsample by selection and
// edge-pad into the MCU-padded u8 component planes.
//
// Replaces the XLA preprocess (`gpujpeg_tpu/ops/preprocess.py:150`,
// `unpack_raw` + `colorspace.transform` + selection + `_edge_pad`) that the
// JAX reference traces into its staged and fused encodes
// (`jax_pipeline._EncContext._build_fn`), in front of K6 and K7.
//
// Input: the raw frame's bytes. Output: the planes of the plan's
// components, concatenated in component order, each (data_height,
// data_width) row-major: what E1p (fdct_quant_planes.cu) reads.
//
// What bounds it: bytes. Each output byte costs a few integer operations;
// the frame is read once and the planes written once (at 8K I420 -> 4:2:0,
// 49.8 MB each way). One thread per output byte, neighbouring threads on
// neighbouring output bytes, so the stores coalesce; the reads of a warp
// fall in one or two rows of the raw frame.
//
// Arithmetic (colorspace.py, exact): forward r = c + (c == 255),
// clamp(((m.r + 128) >> 8) + base); inverse r = (c - base) * 256 / 255
// truncated toward zero (C division), clamp((m.r + 128) >> 8); a pair of
// two non-RGB spaces goes through RGB with the clamp between. `>>` of a
// negative int is an arithmetic shift on the card, as numpy's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PixelFormat values (types.py)
constexpr int kU8 = 0, kP012 = 1, kP1020 = 3, kP012Z = 6, kP012A = 7;
constexpr int kCompCols = 8;  // PlaneGeometry.comp
constexpr int kSrcCols = 5;   // PlaneGeometry.src

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

__global__ void preprocess_planes_kernel(
    const uint8_t* __restrict__ raw, int fmt, int H, int W, int n_ch,
    const int* __restrict__ comp, int C, const int* __restrict__ src,
    const int* __restrict__ xf, uint8_t* __restrict__ out, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    int c = C - 1;
    while (c > 0 && i < comp[c * kCompCols]) --c;
    const int* cp = comp + c * kCompCols;
    const long long local = i - cp[0];
    const int dw = cp[1];
    const int y = (int)(local / dw), x = (int)(local % dw);
    // selection, then the edge pad: clamp to the selected plane
    const int Y = min(y, cp[3] - 1) * cp[5];
    const int X = min(x, cp[4] - 1) * cp[6];
    const int ch = cp[7];
    const long long pix = (long long)Y * W + X;

    int v[4] = {0, 0, 0, 0};
    if (fmt == kU8) {
      v[0] = raw[pix];
    } else if (fmt == kP012) {
      for (int k = 0; k < 3; ++k) v[k] = raw[pix * 3 + k];
    } else if (fmt == kP012Z || fmt == kP012A) {
      for (int k = 0; k < n_ch; ++k) v[k] = raw[pix * 4 + k];
    } else if (fmt == kP1020) {
      // U Y V Y: chroma of pixel pair X/2, replicated to both pixels
      const uint8_t* row = raw + (long long)Y * 2 * W;
      v[0] = row[2 * X + 1];
      v[1] = row[4 * (X >> 1)];
      v[2] = row[4 * (X >> 1) + 2];
    } else {  // planar: nearest replication of each input plane
      for (int k = 0; k < 3; ++k) {
        const int* sp = src + k * kSrcCols;
        v[k] = raw[sp[0] + (long long)(Y / sp[4]) * sp[1] + X / sp[3]];
      }
    }

    if (n_ch >= 3 && ch < 3 && (xf[0] || xf[13])) {
      if (xf[0]) {  // inverse: colour space -> RGB
        int r[3];
        for (int k = 0; k < 3; ++k) r[k] = (v[k] - xf[10 + k]) * 256 / 255;
        int o[3];
        for (int k = 0; k < 3; ++k)
          o[k] = clamp255((xf[1 + 3 * k] * r[0] + xf[2 + 3 * k] * r[1] +
                           xf[3 + 3 * k] * r[2] + 128) >> 8);
        for (int k = 0; k < 3; ++k) v[k] = o[k];
      }
      if (xf[13]) {  // forward: RGB -> colour space
        int r[3];
        for (int k = 0; k < 3; ++k) r[k] = v[k] + (v[k] == 255);
        v[ch] = clamp255(((xf[14 + 3 * ch] * r[0] + xf[15 + 3 * ch] * r[1] +
                           xf[16 + 3 * ch] * r[2] + 128) >> 8) +
                         xf[23 + ch]);
      }
    }
    out[i] = (uint8_t)v[ch];
  }
}

}  // namespace

extern "C" int gj_preprocess_planes(const void* raw, int fmt, int H, int W,
                                    int n_ch, const void* comp, int C,
                                    const void* src, const void* xf,
                                    void* out, int total, void* stream) {
  const int threads = 256;
  long long ctas = ((long long)total + threads - 1) / threads;
  if (ctas > 132 * 32) ctas = 132 * 32;  // grid-stride beyond ~32 CTAs/SM
  if (ctas < 1) ctas = 1;
  preprocess_planes_kernel<<<(unsigned)ctas, threads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)raw, fmt, H, W, n_ch, (const int*)comp, C,
      (const int*)src, (const int*)xf, (uint8_t*)out, (long long)total);
  return (int)cudaGetLastError();
}
