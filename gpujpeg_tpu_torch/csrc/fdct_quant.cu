// E1 fdct_quant: colour transform + blockify + separable f32 DCT +
// quantisation.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stages 1-2 (blockify, DCT+quant), together with the XLA words front end
// that fed it (`rgbpack.pack_plane_words`).
//
// Input: raw interleaved RGB bytes (H, W, 3), H and W multiples of 8.
// Output: int32 coefficients (3 * n_blocks, 64), zig-zag order, in scan
// order: component-major raster blocks (non-interleaved) or Y,Cb,Cr per
// block position (interleaved 4:4:4).
//
// What bounds it: bytes (one read of the pixels, one write of four bytes
// per coefficient, 1 + 4 * 64 / 3 bytes a pixel); the separable DCT's
// 2,176 operations a block and component are well under the card's
// float32 rate. The design keeps both streams coalesced, the loads in
// flight during the arithmetic, and the DCT in its separable form
// (GPUJPEG's, SURVEY.md:70):
//   * a CTA walks strips of 8 pixel rows by kTB blocks (a grid stride);
//     each thread holds its share of the next strip's bytes in registers,
//     loaded with 16-byte loads (8-byte loads where W is not a multiple
//     of 16; 4-byte words gathered from bytes only for an input not
//     8-byte aligned) while
//     the current strip is transformed, and stores them to shared memory
//     when that is done;
//   * thread (b, r) applies the integer colour transform (`xf`) to the 8
//     pixels of row r of block b, one component at a time, and runs that
//     component's 8-point row DCT in registers, into a padded tile per
//     block and component (65 floats: the lanes of a warp, 32 blocks, hit
//     32 banks);
//   * thread (b, u) runs column u of each component's 8-point column DCT
//     in place;
//   * the CTA writes the strip's 64 consecutive words per block and
//     component with 16-byte stores, in the scan order's contiguous runs;
//     a thread's four zig-zag positions are the same in every store, so
//     it reads their natural positions and biases once a strip.
// The colour constants, divisors, biases and zig-zag table sit in shared
// memory, read as broadcasts or once a strip.
// The 8x8 factor `kD8`, the zig-zag table and the two passes
// (`fdct8_row`, `fdct8_col`) come from dct8.cuh, shared with E1p and with
// D2's and D2p's inverse.
//
// Numerics: the DCT runs on the raw pixels (no level shift) as a row pass
// and a column pass of 8 terms each, each sum in k order with explicit
// IEEE fmaf; the zig-zag value then takes the float32 `bias` (the level
// shift, folded into the DC) as one rounded subtraction, and the quotient
// is the IEEE round-to-nearest division `__fdiv_rn` (no reciprocal
// multiply) rounded half-to-even by `rintf`. The plain version multiplies
// by the dense 64x64 operator instead, so a quotient that lies within the
// float32 error bound of .5 may round differently between the two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

constexpr int kTB = 32;             // blocks per strip
constexpr int kThreads = kTB * 8;   // thread (b, r): block b, row/column r
constexpr int kRowBytes = kTB * 24; // pixel bytes of one strip row
constexpr int kTile = 65;           // floats per block and component tile

// A strip's bytes, 8 rows of 24 * n, as this thread's share: up to eight
// words in registers, in units of `ub` bytes: 16 (W a multiple of 16, so
// every strip holds an even number of blocks, and the input 16-byte
// aligned), 8 (the input 8-byte aligned) or a 4-byte word of single
// bytes.
struct Share {
  uint32_t w[8];
};

__device__ __forceinline__ void fetch(Share& sh, const uint8_t* src,
                                      size_t pitch, int n, int ub) {
  const int per_row = n * 24 / ub, total = 8 * per_row;
  if (ub == 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        const uint4 x = reinterpret_cast<const uint4*>(src + row * pitch)[c];
        sh.w[4 * j] = x.x; sh.w[4 * j + 1] = x.y;
        sh.w[4 * j + 2] = x.z; sh.w[4 * j + 3] = x.w;
      }
    }
  } else if (ub == 8) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        const uint2 x = reinterpret_cast<const uint2*>(src + row * pitch)[c];
        sh.w[2 * j] = x.x; sh.w[2 * j + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        const uint8_t* q = src + row * pitch + 4 * c;
        sh.w[j] = q[0] | (q[1] << 8) | (q[2] << 16) | ((uint32_t)q[3] << 24);
      }
    }
  }
}

__device__ __forceinline__ void stash(const Share& sh,
                                      uint8_t (*raw)[kRowBytes], int n,
                                      int ub) {
  const int per_row = n * 24 / ub, total = 8 * per_row;
  if (ub == 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        reinterpret_cast<uint4*>(raw[row])[c] = make_uint4(
            sh.w[4 * j], sh.w[4 * j + 1], sh.w[4 * j + 2], sh.w[4 * j + 3]);
      }
    }
  } else if (ub == 8) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        reinterpret_cast<uint2*>(raw[row])[c] =
            make_uint2(sh.w[2 * j], sh.w[2 * j + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < total) {
        const int row = u / per_row, c = u - row * per_row;
        reinterpret_cast<uint32_t*>(raw[row])[c] = sh.w[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
fdct_quant_kernel(const uint8_t* __restrict__ rgb, int H, int W, int vec,
                  const float* __restrict__ bias,  // (64,) zig-zag
                  const float* __restrict__ qdiv,  // (3, 64) per component
                  const int* __restrict__ xf,      // m9[9], base[3], identity
                  int interleaved, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t raw[8][kRowBytes];
  __shared__ float tile[3 * kTB * kTile];
  __shared__ __align__(16) float s_q[3 * 64];
  __shared__ __align__(16) float s_bias[64];
  __shared__ __align__(16) uint8_t s_nat[64];
  __shared__ int s_xf[13];

  const int tid = threadIdx.x;
  if (tid < 3 * 64) s_q[tid] = qdiv[tid];
  if (tid < 64) {
    s_bias[tid] = bias[tid];
    s_nat[tid] = kZigzagToNatural[tid];
  }
  if (tid < 13) s_xf[tid] = xf[tid];
  // this thread's four zig-zag positions in every 16-byte store
  const int k0 = (tid * 4) & 63;

  const int nbx = W >> 3, nby = H >> 3;
  const int sx = (nbx + kTB - 1) / kTB;  // strips per block row
  const long long n_strips = (long long)sx * nby;
  const long long nblk = (long long)nbx * nby;
  const size_t pitch = (size_t)W * 3;
  const int b = tid & 31;  // block of the strip
  const int r = tid >> 5;  // pixel row (row pass), frequency u (columns)

  auto strip_src = [&](long long s, int& n) {
    const int by = (int)(s / sx), bx0 = (int)(s % sx) * kTB;
    n = min(kTB, nbx - bx0);
    return rgb + (size_t)by * 8 * pitch + (size_t)bx0 * 24;
  };
  Share next;
  int n_next = 0;
  if (blockIdx.x < n_strips) {
    const uint8_t* src = strip_src(blockIdx.x, n_next);
    fetch(next, src, pitch, n_next, vec);
  }

  for (long long s = blockIdx.x; s < n_strips; s += gridDim.x) {
    const int n = n_next;
    const int by = (int)(s / sx), bx0 = (int)(s % sx) * kTB;
    stash(next, raw, n, vec);
    __syncthreads();
    if (s + gridDim.x < n_strips) {  // in flight during the arithmetic
      const uint8_t* src = strip_src(s + gridDim.x, n_next);
      fetch(next, src, pitch, n_next, vec);
    }

    // row pass: colour transform of the 8 pixels of row r of block b, one
    // component at a time, and its 8-point row DCT
    if (b < n) {
      const uint2* p = reinterpret_cast<const uint2*>(&raw[r][24 * b]);
      const uint2 w0 = p[0], w1 = p[1], w2 = p[2];
      const uint32_t wd[6] = {w0.x, w0.y, w1.x, w1.y, w2.x, w2.y};
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const int m0 = s_xf[3 * comp], m1 = s_xf[3 * comp + 1],
                  m2 = s_xf[3 * comp + 2], base = s_xf[9 + comp];
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int c[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int byte = 3 * k + i;
            c[i] = (wd[byte >> 2] >> (8 * (byte & 3))) & 255;
          }
          if (s_xf[12]) {  // identity
            x[k] = (float)c[comp];
          } else {
#pragma unroll
            for (int i = 0; i < 3; ++i) c[i] += (c[i] == 255);
            const int acc = m0 * c[0] + m1 * c[1] + m2 * c[2];
            const int v = ((acc + 128) >> 8) + base;
            x[k] = (float)min(max(v, 0), 255);
          }
        }
        fdct8_row(x, &tile[(comp * kTB + b) * kTile + r * 8]);
      }
    }
    __syncthreads();

    // column pass: column u = r of each component's block b, in place
    if (b < n) {
#pragma unroll
      for (int comp = 0; comp < 3; ++comp)
        fdct8_col(&tile[(comp * kTB + b) * kTile + r]);
    }
    __syncthreads();

    // zig-zag gather, bias, quotient; 16-byte stores of the strip's runs
    // (one run of 3 * 64 * n words interleaved, one of 64 * n words per
    // component otherwise)
    const long long blk0 = (long long)by * nbx + bx0;
    const int run = n * 64;
    const uchar4 nat = *reinterpret_cast<const uchar4*>(&s_nat[k0]);
    const float4 bz = *reinterpret_cast<const float4*>(&s_bias[k0]);
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const int lim = interleaved ? (part == 0 ? 3 * run : 0) : run;
      for (int e = tid * 4; e < lim; e += kThreads * 4) {
        int comp, bb;
        int32_t* dst;
        if (interleaved) {
          bb = e / 192;
          comp = (e - bb * 192) >> 6;
          dst = out + blk0 * 192 + e;
        } else {
          comp = part;
          bb = e >> 6;
          dst = out + ((long long)comp * nblk + blk0) * 64 + e;
        }
        const float* t = &tile[(comp * kTB + bb) * kTile];
        const float4 q =
            *reinterpret_cast<const float4*>(&s_q[comp * 64 + k0]);
        int4 o;
        o.x = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.x], bz.x), q.x));
        o.y = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.y], bz.y), q.y));
        o.z = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.z], bz.z), q.z));
        o.w = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.w], bz.w), q.w));
        *reinterpret_cast<int4*>(dst) = o;
      }
    }
  }
}

}  // namespace

extern "C" int gj_fdct_quant(const void* rgb, int H, int W,
                             const void* bias, const void* qdiv,
                             const void* xf, int interleaved, void* out,
                             void* stream) {
  const uintptr_t a = (uintptr_t)rgb;
  const int vec = (W % 16 == 0 && a % 16 == 0) ? 16 : (a % 8 == 0 ? 8 : 4);
  const long long n_strips =
      (long long)((W / 8 + kTB - 1) / kTB) * (H / 8);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fdct_quant_kernel,
                                                kThreads, 0);
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (ctas > n_strips) ctas = n_strips;
  if (ctas < 1) ctas = 1;
  fdct_quant_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, H, W, vec, (const float*)bias, (const float*)qdiv,
      (const int*)xf, interleaved, (int32_t*)out);
  return (int)cudaGetLastError();
}
