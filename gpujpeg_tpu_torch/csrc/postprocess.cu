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
// planar 4:2:2/4:2:0 outputs select the pixel (r * ry, c * rx) (the
// clamp to (H - 1, W - 1) of `pack_raw` never binds: a planar output
// plane has ceil(H / ry) rows and ceil(W / rx) columns).
//
// What bounds it: bytes on paper (at 8K 4:2:0 to I420, 49.8 MB each way,
// 0.0297 ms at 3.35 TB/s), integer issue in practice: the colour pair of
// every pixel (PERF.md §6 has the stage cuts). The first port ran a thread
// per output byte (planar) or pixel, with two divisions per component and
// three by 255 per item, and for planar output computed the whole
// transformed pixel once per output plane (0.72 ms on (a)). This design:
//   * a CTA takes a band of kBandRows output rows, a warp one row, a lane
//     16 pixels of it at a time; the row's plane rows (y / ry as one
//     multiply, `div_magic`) are found once per row;
//   * where every component's rx is 1 or 2, the 16 pixels' plane bytes are
//     one or two 8-byte loads a component (plane rows and offsets are
//     multiples of 8), rx 2 widened by byte permutes; other chunks (the
//     row's last pixels, rx above 2) take byte loads at x / rx by
//     `div_magic`: no division anywhere;
//   * where both chroma components have rx 2, a pixel pair shares the
//     first step's chroma terms; the last step computes channels 1 and 2
//     only for the pixels that keep them (UYVY: even pixels; planar
//     4:2:x: even pixels of selected rows);
//   * the lane packs its output in registers and writes it with the widest
//     stores the address allows (`store_words`): 16 bytes of U8, 48 of
//     P012 (three 16-byte stores on a 16-byte aligned row), 64 of
//     P012Z/A, 32 of UYVY;
//   * planar output: the lane that transforms a pixel writes it to every
//     output plane that selects it (I420: pixel (2r, 2c) to Y, U and V),
//     so no pixel is transformed twice;
//   * the geometry and the colour constants reach the kernel by value
//     (`__grid_constant__`), and the kernel is templated on the output
//     layout, the steps of the colour pair and the chroma pairing.
// All offsets are 32-bit: the wrapper checks that every size is below
// 2**31 and that `div_magic` is exact for the frame's rows and columns.
//
// Arithmetic (colorspace.py, exact, no division): inverse r = d + (d ==
// 255) - (d == -255), d = c - base (= trunc(d * 256 / 255)), clamp((m.r +
// 128) >> 8); forward r = c + (c == 255), clamp(((m.r + 128) >> 8) +
// base); a pair of two non-RGB spaces goes through RGB with the clamp
// between. A 4th channel passes through; fewer than 3 channels take no
// transform.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel_io.cuh"

namespace {

using namespace pixio;  // formats, layouts, steps, arithmetic

constexpr int kOutCols = 6;   // OutGeometry.comp
constexpr int kDstCols = 5;   // OutGeometry.dst
constexpr int kN = 16;        // pixels a lane packs at a time

struct Comp {
  int off, dw, rx;
  unsigned my, mx;  // div_magic multipliers of ry and rx
};

struct Args {
  const uint8_t* planes;
  uint8_t* out;
  int H, W, C;
  int n_ch, fill;  // interleaved 4:4:4: channels written, the rest's value
  bool span;       // every component's rx is 1 or 2
  Comp c[4];
  int dst_off[3], dst_w[3], dst_sy;
  pixio::Pair xf;
};

// The first step's terms in channels 1 and 2, + 128, for each output row.
// Pixels that share their channels 1 and 2 (a chroma sample replicated to
// a pixel pair) share them.
struct Part {
  int s0, s1, s2;
};

template <int XF>
__device__ __forceinline__ Part part(const pixio::Pair& x, int v1, int v2) {
  if constexpr ((XF & kInv) != 0) {
    const int r1 = unexpand255(v1 - x.bi[1]), r2 = unexpand255(v2 - x.bi[2]);
    return {x.mi[1] * r1 + x.mi[2] * r2 + 128,
            x.mi[4] * r1 + x.mi[5] * r2 + 128,
            x.mi[7] * r1 + x.mi[8] * r2 + 128};
  } else {
    const int e1 = expand255(v1), e2 = expand255(v2);
    return {x.mf[1] * e1 + x.mf[2] * e2 + 128,
            x.mf[4] * e1 + x.mf[5] * e2 + 128,
            x.mf[7] * e1 + x.mf[8] * e2 + 128};
  }
}

// The output channels of a pixel from its channel 0 and its Part; channels
// 1 and 2 of the last step only where ``all`` (a planar or UYVY output
// takes them from some pixels only).
template <int XF>
__device__ __forceinline__ void finish(const pixio::Pair& x, const Part& p,
                                       int v0, bool all, int* v) {
  if constexpr ((XF & kInv) != 0) {
    const int r0 = unexpand255(v0 - x.bi[0]);
    if constexpr (XF == kInv) {
      v[0] = clamp255((x.mi[0] * r0 + p.s0) >> 8);
      if (all) {
        v[1] = clamp255((x.mi[3] * r0 + p.s1) >> 8);
        v[2] = clamp255((x.mi[6] * r0 + p.s2) >> 8);
      }
    } else {
      const int e0 = pixio::clamp_expand255((x.mi[0] * r0 + p.s0) >> 8),
                e1 = pixio::clamp_expand255((x.mi[3] * r0 + p.s1) >> 8),
                e2 = pixio::clamp_expand255((x.mi[6] * r0 + p.s2) >> 8);
      v[0] = clamp255(
          ((x.mf[0] * e0 + x.mf[1] * e1 + x.mf[2] * e2 + 128) >> 8) +
          x.bf[0]);
      if (all) {
        v[1] = clamp255(
            ((x.mf[3] * e0 + x.mf[4] * e1 + x.mf[5] * e2 + 128) >> 8) +
            x.bf[1]);
        v[2] = clamp255(
            ((x.mf[6] * e0 + x.mf[7] * e1 + x.mf[8] * e2 + 128) >> 8) +
            x.bf[2]);
      }
    }
  } else {
    const int e0 = expand255(v0);
    v[0] = clamp255(((x.mf[0] * e0 + p.s0) >> 8) + x.bf[0]);
    if (all) {
      v[1] = clamp255(((x.mf[3] * e0 + p.s1) >> 8) + x.bf[1]);
      v[2] = clamp255(((x.mf[6] * e0 + p.s2) >> 8) + x.bf[2]);
    }
  }
}

// The output channels of pixel j of a chunk from its plane words. PAIR:
// channels 1 and 2 are equal in pixels 2i and 2i + 1, whose Part ``pt``
// pixel 2i computes.
template <int XF, bool PAIR>
__device__ __forceinline__ void pixel(const Args& a, const uint32_t (&w)[4][4],
                                      int j, bool all, Part& pt, int v[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = pixio::byte_of(w[c], j);
  if constexpr (XF != kNone) {
    if (!PAIR || (j & 1) == 0) pt = part<XF>(a.xf, v[1], v[2]);
    finish<XF>(a.xf, pt, v[0], all, v);
  }
}

// One interleaved or planar chunk of kN pixels from their plane words.
// SEL: the row feeds planes 1 and 2 of a planar output.
template <int L, int SX, int XF, bool PAIR, bool SEL>
__device__ __forceinline__ void store_chunk(const Args& a,
                                            const uint32_t (&w)[4][4], int Y,
                                            int X0) {
  const int p = Y * a.W + X0;
  Part pt = {0, 0, 0};
  if constexpr (L == kLU8) {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int v[4];
        pixel<XF, PAIR>(a, w, 4 * i + q, false, pt, v);
        b[q] = v[0];
      }
      o[i] = pixio::pack4(b[0], b[1], b[2], b[3]);
    }
    pixio::store_words(a.out + p, o);
  } else if constexpr (L == kL3 || L == kL4) {
    constexpr int kS = L == kL3 ? 3 : 4;
    int b[kS * kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      int v[4];
      pixel<XF, PAIR>(a, w, j, true, pt, v);
#pragma unroll
      for (int k = 0; k < kS; ++k) b[kS * j + k] = k < a.n_ch ? v[k] : a.fill;
    }
    uint32_t o[kS * kN / 4];
#pragma unroll
    for (int i = 0; i < kS * kN / 4; ++i)
      o[i] = pixio::pack4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    pixio::store_words(a.out + kS * p, o);
  } else if constexpr (L == kLUYVY) {
    uint32_t o[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      int e[4], d[4];
      pixel<XF, PAIR>(a, w, 2 * i, true, pt, e);
      pixel<XF, PAIR>(a, w, 2 * i + 1, false, pt, d);
      o[i] = pixio::pack4(e[1], e[0], e[2], d[0]);
    }
    pixio::store_words(a.out + 2 * p, o);
  } else {
    constexpr int kC = kN >> SX;
    int b[3][kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      int v[4];
      pixel<XF, PAIR>(a, w, j, SEL && (j & SX) == 0, pt, v);
#pragma unroll
      for (int k = 0; k < 3; ++k) b[k][j] = v[k];
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = pixio::pack4(b[0][4 * i], b[0][4 * i + 1], b[0][4 * i + 2],
                          b[0][4 * i + 3]);
    pixio::store_words(a.out + a.dst_off[0] + p, o);
    if constexpr (SEL) {
#pragma unroll
      for (int k = 1; k < 3; ++k) {
        uint32_t h[kC / 4];
#pragma unroll
        for (int i = 0; i < kC / 4; ++i)
          h[i] = pixio::pack4(b[k][(4 * i) << SX], b[k][(4 * i + 1) << SX],
                              b[k][(4 * i + 2) << SX],
                              b[k][(4 * i + 3) << SX]);
        pixio::store_words(a.out + a.dst_off[k] +
                               (Y >> a.dst_sy) * a.dst_w[k] + (X0 >> SX),
                           h);
      }
    }
  }
}

// One pixel X of row Y (byte loads and stores): the row's last pixels,
// or every pixel where a component's rx is above 2.
template <int L, int SX, int XF>
__device__ __forceinline__ void store_pixel(const Args& a,
                                            const uint8_t* const (&row)[4],
                                            int Y, int X) {
  int v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < a.C) v[c] = row[c][pixio::div_magic(X, a.c[c].mx)];
  if constexpr (XF != kNone)
    finish<XF>(a.xf, part<XF>(a.xf, v[1], v[2]), v[0], true, v);
  const int p = Y * a.W + X;
  if constexpr (L == kLU8) {
    a.out[p] = (uint8_t)v[0];
  } else if constexpr (L == kL3) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a.out[3 * p + k] = (uint8_t)(k < a.n_ch ? v[k] : a.fill);
  } else if constexpr (L == kL4) {
    int b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = k < a.n_ch ? v[k] : a.fill;
    reinterpret_cast<uint32_t*>(a.out)[p] = pixio::pack4(b[0], b[1], b[2],
                                                         b[3]);
  } else if constexpr (L == kLUYVY) {
    a.out[2 * p + 1] = (uint8_t)v[0];
    if ((X & 1) == 0) {
      a.out[2 * p] = (uint8_t)v[1];
      if (X + 1 < a.W) a.out[2 * p + 2] = (uint8_t)v[2];
    }
  } else {
    a.out[a.dst_off[0] + p] = (uint8_t)v[0];
    if ((Y & a.dst_sy) == 0 && (X & SX) == 0) {
#pragma unroll
      for (int k = 1; k < 3; ++k)
        a.out[a.dst_off[k] + (Y >> a.dst_sy) * a.dst_w[k] + (X >> SX)] =
            (uint8_t)v[k];
    }
  }
}

template <int L, int SX, int XF, bool PAIR>
__global__ void __launch_bounds__(kBandRows * 32)
    postprocess_planes_kernel(const __grid_constant__ Args a) {
  const int Y = blockIdx.x * kBandRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (Y >= a.H) return;
  const uint8_t* row[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    row[c] = c < a.C ? a.planes + a.c[c].off +
                           pixio::div_magic(Y, a.c[c].my) * a.c[c].dw
                     : a.planes;
  for (int X0 = lane * kN; X0 < a.W; X0 += 32 * kN) {
    if (a.span && X0 + kN <= a.W) {
      uint32_t w[4][4] = {};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= a.C) continue;
        if (a.c[c].rx == 1) {
          const uint2 lo = *reinterpret_cast<const uint2*>(row[c] + X0);
          const uint2 hi = *reinterpret_cast<const uint2*>(row[c] + X0 + 8);
          w[c][0] = lo.x;
          w[c][1] = lo.y;
          w[c][2] = hi.x;
          w[c][3] = hi.y;
        } else {  // rx 2: each plane byte twice
          const uint2 h = *reinterpret_cast<const uint2*>(row[c] + (X0 >> 1));
          w[c][0] = __byte_perm(h.x, 0, 0x1100);
          w[c][1] = __byte_perm(h.x, 0, 0x3322);
          w[c][2] = __byte_perm(h.y, 0, 0x1100);
          w[c][3] = __byte_perm(h.y, 0, 0x3322);
        }
      }
      if (L != kLPlanar || (Y & a.dst_sy) == 0)
        store_chunk<L, SX, XF, PAIR, true>(a, w, Y, X0);
      else
        store_chunk<L, SX, XF, PAIR, false>(a, w, Y, X0);
    } else {
      const int end = min(X0 + kN, a.W);
      for (int X = X0; X < end; ++X) store_pixel<L, SX, XF>(a, row, Y, X);
    }
  }
}

template <int L, int SX, int XF>
cudaError_t launch3(const Args& a, bool pair, cudaStream_t s) {
  const dim3 grid((a.H + kBandRows - 1) / kBandRows), block(kBandRows * 32);
  if (pair)
    postprocess_planes_kernel<L, SX, XF, true><<<grid, block, 0, s>>>(a);
  else
    postprocess_planes_kernel<L, SX, XF, false><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

// steps: the colour pair's steps; pair: channels 1 and 2 are replicated
// to pixel pairs (both components' rx 2), so their Part is shared.
template <int L, int SX>
cudaError_t launch(const Args& a, int steps, bool pair, cudaStream_t s) {
  switch (steps) {
    case kNone:
      return launch3<L, SX, kNone>(a, false, s);
    case kInv:
      return launch3<L, SX, kInv>(a, pair, s);
    case kFwd:
      return launch3<L, SX, kFwd>(a, pair, s);
    default:
      return launch3<L, SX, kBoth>(a, pair, s);
  }
}

}  // namespace

// host: fmt, H, W, C, then C rows of OutGeometry.comp, C (ry, rx)
// div_magic multipliers (OutGeometry.magic), the 3 rows of OutGeometry.dst
// and the 26 pair constants.
extern "C" int gj_postprocess_planes(const void* planes, const void* host,
                                     void* out, void* stream) {
  const int* h = (const int*)host;
  const int fmt = h[0], H = h[1], W = h[2], C = h[3];
  if (C < 1 || C > 4 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)planes % 8 || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const int* comp = h + 4;
  const int* magic = comp + C * kOutCols;
  const int* dst = magic + 2 * C;
  Args a = {};
  a.planes = (const uint8_t*)planes;
  a.out = (uint8_t*)out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.span = true;
  for (int c = 0; c < C; ++c) {
    const int* cp = comp + c * kOutCols;
    if (cp[0] % 8 || cp[1] % 8 || cp[4] < 1 || cp[5] < 1)
      return (int)cudaErrorInvalidValue;
    a.c[c] = {cp[0], cp[1], cp[5], (unsigned)magic[2 * c],
              (unsigned)magic[2 * c + 1]};
    a.span = a.span && cp[5] <= 2;
  }
  for (int i = 0; i < 3; ++i) {
    a.dst_off[i] = dst[i * kDstCols];
    a.dst_w[i] = dst[i * kDstCols + 1];
  }
  a.dst_sy = dst[kDstCols + 4] == 2 ? 1 : 0;  // plane 1's row selection
  a.xf = pixio::pair_from(dst + 3 * kDstCols);
  const int steps =
      C < 3 ? kNone : (a.xf.inv ? kInv : 0) | (a.xf.fwd ? kFwd : 0);
  const bool pair = C >= 3 && a.c[1].rx == 2 && a.c[2].rx == 2;
  a.n_ch = fmt == kP012A && C >= 4 ? 4 : min(C, 3);
  a.fill = fmt == kP012A && C < 4 ? 255 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case kU8:
      return (int)launch<kLU8, 0>(a, steps, pair, s);
    case kP012:
      return (int)launch<kL3, 0>(a, steps, pair, s);
    case kP012Z:
    case kP012A:
      return (int)launch<kL4, 0>(a, steps, pair, s);
    case kP1020:
      if (C < 3 || (W % 2 && W > 1)) return (int)cudaErrorInvalidValue;
      return (int)launch<kLUYVY, 0>(a, steps, pair, s);
    case kP444:
      if (C < 3) return (int)cudaErrorInvalidValue;
      return (int)launch<kLPlanar, 0>(a, steps, pair, s);
    case kP422:
    case kP420:
      if (C < 3) return (int)cudaErrorInvalidValue;
      return (int)launch<kLPlanar, 1>(a, steps, pair, s);
  }
  return (int)cudaErrorInvalidValue;
}
