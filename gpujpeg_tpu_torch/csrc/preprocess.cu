// E0 preprocess_planes: unpack any of the 8 raw pixel formats, apply the
// integer colour transform of any colour pair, subsample by selection and
// edge-pad into the MCU-padded u8 component planes.
//
// Replaces the XLA preprocess (`gpujpeg_tpu/ops/preprocess.py:150`,
// `unpack_raw` + `colorspace.transform` + selection + `_edge_pad`) that the
// JAX reference traces into its staged and fused encodes
// (`jax_pipeline._EncContext._build_fn`), in front of K6 and K7, and the
// RGB word pack of `scripts/perf_rgbpack.py:47` (S3).
//
// Input: the raw frame's bytes (4-byte aligned). Output: the planes of the
// plan's components, concatenated in component order, each (data_height,
// data_width) row-major: what E1p (fdct_quant_planes.cu) reads. Plane
// byte (y, x) of channel ch is the transformed channel ch of raw pixel
// (min(y, rows_sel - 1) * ry, min(x, cols_sel - 1) * rx).
//
// What bounds it: bytes on paper (at 8K I420 -> 4:2:0, 49.8 MB each way,
// 0.0297 ms at 3.35 TB/s), integer issue in practice: (a)'s pair (BT.709
// -> RGB -> BT.601) costs some 30-50 instructions an output byte, and with
// the transform cut the kernel still reads each raw row once per plane
// (PERF.md §6 has the stage cuts). The first port ran a thread per output
// byte with a plane search, a 64-bit division, up to six more divisions
// and some 40 global loads of its constants per byte (0.72 ms on (a)).
// This design:
//   * a CTA takes a band of kBandRows raw rows and writes every plane row
//     that selects from it (a host table, `PlaneGeometry.bands`, gives
//     each band's first row per plane, padding rows included), so the
//     planes of one frame row read it close in time and it comes from
//     DRAM once; a warp takes a plane row, a lane 8 output bytes of it at
//     a time, written with one 8-byte store (data widths are multiples of
//     8);
//   * the row's selected raw row, its input row pointers, its matrix row
//     and the choice of its code (steps of the pair, rx 1, 2 or other) are
//     made once per row; a column is a multiply of the lane's first
//     column, a planar input's replication a shift: no division anywhere;
//   * the 8 bytes' input span (rx 1 or 2, inside the selected columns and
//     the row) is read as aligned 4-byte words realigned by a funnel shift
//     (4-byte pixels: one word a pixel); other chunks (the row's last
//     selected columns, edge padding, rx above 2) take byte loads;
//   * where two pixels share their chroma (UYVY, planar 4:2:x input), the
//     first step's chroma terms are computed once for the pair;
//   * the geometry and the colour constants reach the kernel by value
//     (`__grid_constant__`), and the kernel is templated on the raw layout
//     and on the steps of the colour pair.
//
// Arithmetic (colorspace.py, exact, no division): forward r = c + (c ==
// 255), clamp(((m.r + 128) >> 8) + base); inverse r = d + (d == 255) -
// (d == -255), d = c - base (= trunc(d * 256 / 255)), clamp((m.r + 128)
// >> 8); a pair of two non-RGB spaces goes through RGB with the clamp
// between. `>>` of a negative int is an arithmetic shift on the card, as
// numpy's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel_io.cuh"

namespace {

using namespace pixio;  // formats, layouts, steps, arithmetic

constexpr int kCompCols = 8;  // PlaneGeometry.comp
constexpr int kSrcCols = 5;   // PlaneGeometry.src
constexpr int kWarps = 8;
constexpr int kN = 8;         // output bytes a lane writes at a time

struct Plane {
  int off, dw, rows_sel, cols_sel, ry, rx, ch;
};

struct Args {
  const uint8_t* raw;
  uint8_t* out;
  const int* bands;  // (n_bands + 1, C) first row of each band per plane
  int W, C, row_bytes;  // row_bytes: W * bytes a pixel (interleaved)
  Plane p[4];
  int src_off[3], src_w[3], src_sy[3];
  pixio::Pair xf;
};

// The input rows of one selected raw row.
struct Rows {
  const uint8_t* p[3];
};

// Row ch of the last step of the pair: c0..c2 its matrix row, cb its base
// (0 for the inverse).
struct Coef {
  int c0, c1, c2, cb;
};

// The first step's terms in channels 1 and 2, + 128: three rows where the
// inverse is followed by the forward, else row ch. Pixels that share their
// channels 1 and 2 (chroma replicated to a pixel pair) share them.
struct Part {
  int s0, s1, s2;
};

template <int XF>
__device__ __forceinline__ Part part(const pixio::Pair& x, const Coef& k,
                                     int v1, int v2) {
  if constexpr (XF == kBoth) {
    const int r1 = unexpand255(v1 - x.bi[1]), r2 = unexpand255(v2 - x.bi[2]);
    return {x.mi[1] * r1 + x.mi[2] * r2 + 128,
            x.mi[4] * r1 + x.mi[5] * r2 + 128,
            x.mi[7] * r1 + x.mi[8] * r2 + 128};
  } else if constexpr (XF == kInv) {
    return {k.c1 * unexpand255(v1 - x.bi[1]) +
                k.c2 * unexpand255(v2 - x.bi[2]) + 128, 0, 0};
  } else {
    return {k.c1 * expand255(v1) + k.c2 * expand255(v2) + 128, 0, 0};
  }
}

// Channel ch of a pixel from its channel 0 and its Part.
template <int XF>
__device__ __forceinline__ int finish(const pixio::Pair& x, const Coef& k,
                                      const Part& p, int v0) {
  if constexpr (XF == kInv) {
    return clamp255((k.c0 * unexpand255(v0 - x.bi[0]) + p.s0) >> 8);
  } else if constexpr (XF == kFwd) {
    return clamp255(((k.c0 * expand255(v0) + p.s0) >> 8) + k.cb);
  } else {
    const int r0 = unexpand255(v0 - x.bi[0]);
    const int R = pixio::clamp_expand255((x.mi[0] * r0 + p.s0) >> 8);
    const int G = pixio::clamp_expand255((x.mi[3] * r0 + p.s1) >> 8);
    const int B = pixio::clamp_expand255((x.mi[6] * r0 + p.s2) >> 8);
    return clamp255(((k.c0 * R + k.c1 * G + k.c2 * B + 128) >> 8) + k.cb);
  }
}

// The channels of raw pixel X (byte loads).
template <int L, int SX>
__device__ __forceinline__ void fetch1(const Rows& r, int X, int v[4]) {
  if constexpr (L == kLU8) {
    v[0] = r.p[0][X];
  } else if constexpr (L == kL3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = r.p[0][3 * X + k];
  } else if constexpr (L == kL4) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(r.p[0])[X];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (int)((w >> (8 * k)) & 0xFFu);
  } else if constexpr (L == kLUYVY) {  // U Y V Y: chroma of pixel pair X / 2
    v[0] = r.p[0][2 * X + 1];
    v[1] = r.p[0][4 * (X >> 1)];
    v[2] = r.p[0][4 * (X >> 1) + 2];
  } else {
    v[0] = r.p[0][X];
    v[1] = r.p[1][X >> SX];
    v[2] = r.p[2][X >> SX];
  }
}

// The channels of the kN pixels (x0 + j) * RX, j < kN, from their span
// (RX 1 or 2; the caller checks that the span lies in the row).
template <int L, int SX, int RX>
__device__ __forceinline__ void fetch_span(const Rows& r, int x0,
                                           int v[4][kN]) {
  const int X0 = x0 * RX;
  if constexpr (L == kLU8) {
    uint32_t w[2 * RX];
    pixio::load_span(r.p[0] + X0, w);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      v[0][j] = pixio::byte_of(w, j * RX);
  } else if constexpr (L == kL3) {
    uint32_t w[6 * RX];
    pixio::load_span(r.p[0] + 3 * X0, w);
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = 3 * j * RX + k;
        v[k][j] = pixio::byte_of(w, i);
      }
  } else if constexpr (L == kL4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(r.p[0]) + X0;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const uint32_t w = __ldg(q + j * RX);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k][j] = (int)((w >> (8 * k)) & 0xFFu);
    }
  } else if constexpr (L == kLUYVY) {  // X0 is even: the span starts a pair
    uint32_t w[4 * RX];
    pixio::load_span(r.p[0] + 2 * X0, w);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = 2 * j * RX + 1, u = 4 * ((j * RX) >> 1);
      v[0][j] = pixio::byte_of(w, i);
      v[1][j] = (int)(w[u >> 2] & 0xFFu);
      v[2][j] = (int)((w[u >> 2] >> 16) & 0xFFu);
    }
  } else {
    uint32_t w0[2 * RX];
    pixio::load_span(r.p[0] + X0, w0);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      v[0][j] = pixio::byte_of(w0, j * RX);
    constexpr int kNW = (2 * RX) >> SX;  // X0 is even where SX is 1
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      uint32_t w[kNW];
      pixio::load_span(r.p[k] + (X0 >> SX), w);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int i = (j * RX) >> SX;
        v[k][j] = pixio::byte_of(w, i);
      }
    }
  }
}

template <int L, int XF>
__device__ __forceinline__ int out_byte(const pixio::Pair& x, const Coef& k,
                                        int ch, const int* v) {
  if constexpr (XF != kNone)
    return finish<XF>(x, k, part<XF>(x, k, v[1], v[2]), v[0]);
  constexpr int kCh = L == kLU8 ? 1 : L == kL4 ? 4 : 3;
  int o = v[0];
#pragma unroll
  for (int c = 1; c < kCh; ++c) o = ch == c ? v[c] : o;
  return o;
}

// One plane row: lane chunks of kN bytes.
template <int L, int SX, int XF, int RX>
__device__ __forceinline__ void plane_row(const Args& a, const Plane& P,
                                          const Rows& r, const Coef& k,
                                          uint8_t* dst, int lane) {
  const int cs = P.cols_sel, rx = P.rx;
  for (int x0 = lane * kN; x0 < P.dw; x0 += 32 * kN) {
    int o[kN];
    bool span = false;
    if constexpr (RX > 0) {
      span = x0 + kN <= cs && (x0 + kN) * RX <= a.W;
      if (span) {
        int v[4][kN] = {};
        fetch_span<L, SX, RX>(r, x0, v);
        // pixel pairs that share channels 1 and 2 share their Part
        constexpr bool kShare =
            XF != kNone && RX == 1 &&
            (L == kLUYVY || (L == kLPlanar && SX == 1));
        Part pt = {0, 0, 0};
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          if constexpr (kShare) {
            if ((j & 1) == 0) pt = part<XF>(a.xf, k, v[1][j], v[2][j]);
            o[j] = finish<XF>(a.xf, k, pt, v[0][j]);
          } else {
            const int vj[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
            o[j] = out_byte<L, XF>(a.xf, k, P.ch, vj);
          }
        }
      }
    }
    if (!span) {  // edge columns, padding, or rx above 2
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        int v[4] = {0, 0, 0, 0};
        fetch1<L, SX>(r, min(x0 + j, cs - 1) * rx, v);
        o[j] = out_byte<L, XF>(a.xf, k, P.ch, v);
      }
    }
    *reinterpret_cast<uint2*>(dst + x0) =
        make_uint2(pixio::pack4(o[0], o[1], o[2], o[3]),
                   pixio::pack4(o[4], o[5], o[6], o[7]));
  }
}

template <int L, int SX, int XF>
__device__ __forceinline__ void row_by_rx(const Args& a, const Plane& P,
                                          const Rows& r, const Coef& k,
                                          uint8_t* dst, int lane) {
  if (P.rx == 1)
    plane_row<L, SX, XF, 1>(a, P, r, k, dst, lane);
  else if (P.rx == 2)
    plane_row<L, SX, XF, 2>(a, P, r, k, dst, lane);
  else
    plane_row<L, SX, XF, 0>(a, P, r, k, dst, lane);
}

template <int L, int SX, int XF>
__global__ void __launch_bounds__(kWarps * 32)
    preprocess_planes_kernel(const __grid_constant__ Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* b0 = a.bands + blockIdx.x * a.C;
  int first[4], count[4], total = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    first[c] = c < a.C ? b0[c] : 0;
    count[c] = c < a.C ? b0[a.C + c] - first[c] : 0;
    total += count[c];
  }
  for (int j = warp; j < total; j += kWarps) {
    // the band's j-th row: plane c, row y (planes in order)
    int c = 0, y = 0, left = j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (left >= 0 && left < count[i]) {
        c = i;
        y = first[i] + left;
      }
      left -= count[i];
    }
    Plane P = a.p[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (c == i) P = a.p[i];
    const int Y = min(y, P.rows_sel - 1) * P.ry;
    Rows r;
    if constexpr (L == kLPlanar) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        r.p[i] = a.raw + a.src_off[i] +
                 (size_t)(Y >> a.src_sy[i]) * a.src_w[i];
    } else {
      r.p[0] = r.p[1] = r.p[2] = a.raw + (size_t)Y * a.row_bytes;
    }
    Coef k = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (P.ch == i) {
        const int* m = XF == kInv ? a.xf.mi : a.xf.mf;
        k = {m[3 * i], m[3 * i + 1], m[3 * i + 2],
             XF == kInv ? 0 : a.xf.bf[i]};
      }
    uint8_t* dst = a.out + P.off + (size_t)y * P.dw;
    if (XF == kNone || P.ch == 3)  // a 4th channel passes through
      row_by_rx<L, SX, kNone>(a, P, r, k, dst, lane);
    else
      row_by_rx<L, SX, XF>(a, P, r, k, dst, lane);
  }
}

template <int L, int SX>
cudaError_t launch(const Args& a, int n_bands, cudaStream_t s) {
  const int steps = (a.xf.inv ? kInv : 0) | (a.xf.fwd ? kFwd : 0);
  const dim3 grid(n_bands), block(kWarps * 32);
  switch (steps) {
    case kNone:
      preprocess_planes_kernel<L, SX, kNone><<<grid, block, 0, s>>>(a);
      break;
    case kInv:
      preprocess_planes_kernel<L, SX, kInv><<<grid, block, 0, s>>>(a);
      break;
    case kFwd:
      preprocess_planes_kernel<L, SX, kFwd><<<grid, block, 0, s>>>(a);
      break;
    default:
      preprocess_planes_kernel<L, SX, kBoth><<<grid, block, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// host: fmt, H, W, C, then C rows of PlaneGeometry.comp, the 3 rows
// of PlaneGeometry.src and the 26 pair constants; bands: (n_bands + 1, C)
// int32 on the card.
extern "C" int gj_preprocess_planes(const void* raw, const void* host,
                                    const void* bands, int n_bands, void* out,
                                    void* stream) {
  const int* h = (const int*)host;
  const int fmt = h[0], H = h[1], W = h[2], C = h[3];
  if (C < 1 || C > 4 || H < 1 || W < 1 || n_bands < 1 ||
      n_bands != (H + kBandRows - 1) / kBandRows)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)raw % 4 || (uintptr_t)out % 8)
    return (int)cudaErrorMisalignedAddress;
  const int* comp = h + 4;
  const int* src = comp + C * kCompCols;
  Args a = {};
  a.raw = (const uint8_t*)raw;
  a.out = (uint8_t*)out;
  a.bands = (const int*)bands;
  a.W = W;
  a.C = C;
  for (int c = 0; c < C; ++c) {
    const int* cp = comp + c * kCompCols;
    if (cp[0] % 8 || cp[1] % 8 || cp[3] < 1 || cp[4] < 1 || cp[5] < 1 ||
        cp[6] < 1)
      return (int)cudaErrorInvalidValue;
    a.p[c] = {cp[0], cp[1], cp[3], cp[4], cp[5], cp[6], cp[7]};
  }
  for (int i = 0; i < 3; ++i) {
    const int* sp = src + i * kSrcCols;
    a.src_off[i] = sp[0];
    a.src_w[i] = sp[1];
    a.src_sy[i] = sp[4] == 2 ? 1 : 0;
  }
  a.xf = pixio::pair_from(src + 3 * kSrcCols);
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case kU8:
      a.row_bytes = W;
      return (int)launch<kLU8, 0>(a, n_bands, s);
    case kP012:
      a.row_bytes = 3 * W;
      return (int)launch<kL3, 0>(a, n_bands, s);
    case kP012Z:
    case kP012A:
      a.row_bytes = 4 * W;
      return (int)launch<kL4, 0>(a, n_bands, s);
    case kP1020:
      if (W % 2) return (int)cudaErrorInvalidValue;
      a.row_bytes = 2 * W;
      return (int)launch<kLUYVY, 0>(a, n_bands, s);
    case kP444:
      return (int)launch<kLPlanar, 0>(a, n_bands, s);
    case kP422:
    case kP420:
      return (int)launch<kLPlanar, 1>(a, n_bands, s);
  }
  return (int)cudaErrorInvalidValue;
}
