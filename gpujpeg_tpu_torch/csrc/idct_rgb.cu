// D2 idct_rgb: dequantisation + separable f32 IDCT + inverse colour
// transform + unblockify, from zig-zag coefficients to interleaved RGB
// bytes.
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
// writes), 16-byte aligned; `quant` (n_q, 64) f32 zig-zag quantisation
// tables; `q_of[3]` each component's table; `xf[13]` the inverse-transform
// constants (m9, base3, identity flag). Output: (H, W, 3) uint8.
//
// What bounds it: bytes (four bytes read per coefficient, one written per
// value: 4 * 64 + 1 bytes a pixel and component); the separable IDCT's
// 2,176 operations a block and component are well under the card's float32
// rate. The design is E1's (fdct_quant.cu) mirrored, with the loads moved
// off the threads, since here they are four fifths of the bytes:
//   * a CTA walks strips of 8 pixel rows by kTB block positions (a grid
//     stride). A strip's 24 KB of coefficients are contiguous runs (three
//     of 64 * n words, or one of 192 * n when interleaved), so one thread
//     copies them into a ring of kStages shared buffers with bulk copies
//     (`cp.async.bulk`, the TMA's one-dimensional form), completed on an
//     mbarrier per buffer; two strips are in flight while one is
//     transformed, and no register holds a load;
//   * the CTA dequantises the strip into a padded tile per block and
//     component in natural order (65 floats: the lanes of a warp, 32
//     blocks, hit 32 banks); a thread's four zig-zag positions are the same
//     in every 16-byte unit, so it reads their natural positions once;
//   * thread (b, u) runs the 8-point column IDCT of column u of block b in
//     place, one component at a time;
//   * thread (b, y) runs row y of the three components, so it holds 8
//     adjacent pixels of one image row: it adds 128, rounds and clamps,
//     applies the integer colour transform and writes the 24 bytes with
//     three 8-byte stores; a warp's 32 blocks write 768 contiguous bytes.
//
// Numerics: per value X_k = x_k * q_k (one rounded multiply); the column
// pass t[y][u] = sum_v D[v][y] X[v][u] and the row pass f[y][x] =
// sum_u t[y][u] D[u][x] (D = kD8, dct8.cuh). Each 8-point sum is split by
// the factor's symmetry (row v of D is even or odd about its middle,
// exactly so in float32): E = the even-v terms and O = the odd-v terms,
// each summed in index order with explicit IEEE fmaf from 0, then out[j] =
// E + O and out[7 - j] = E - O, one rounding each (32 FMAs and 8 adds a
// pass, not 64 FMAs); then + 128 (one rounding), rintf (half to even)
// and a clamp to [0, 255]. The plain version multiplies by the dense 64x64
// operator instead (`dct.dequant_idct_device`), so a value that lies within
// the float32 error bound of .5 may round differently between the two. Then
// per pixel the exact integer inverse (`colorspace._transform_from`): r =
// (c - base) * 256 / 255 with C truncation toward zero, out = clamp((m.r +
// 128) >> 8, 0, 255) with an arithmetic shift.
// The two passes (`idct8_col`, `idct8_row_u8`) come from dct8.cuh and the
// ring's bulk copies from bulk_ring.cuh, both shared with D2p.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"
#include "dct8.cuh"

namespace {

constexpr int kTB = 32;               // block positions per strip
constexpr int kThreads = kTB * 8;     // thread (b, r): block b, column/row r
constexpr int kTile = 65;             // floats per block and component tile
constexpr int kStrip = 3 * kTB * 64;  // coefficients of a strip
constexpr int kPer = kStrip / 4 / kThreads;  // 16-byte units per thread
constexpr int kStages = 3;            // ring buffers: two strips in flight

struct __align__(16) Smem {
  int32_t raw[kStages][kStrip];  // bulk-copy ring, the scan order's layout
  float tile[3 * kTB * kTile];
  float q[3 * 64];
  uint64_t full[kStages];        // mbarriers: a buffer's copies landed
  uint8_t nat[64];
  int xf[13];
};

// one thread: copy strip (blk0, n) into `dst`, completing on `bar`
__device__ __forceinline__ void copy_strip(int32_t* dst, uint64_t* bar,
                                      const int32_t* coeff, long long nblk,
                                      long long blk0, int n, int interleaved) {
  bulk_expect(bar, n * 768);
  const int parts = interleaved ? 1 : 3;
  const uint32_t bytes = interleaved ? n * 768 : n * 256;
  for (int c = 0; c < parts; ++c) {
    const int32_t* src =
        interleaved ? coeff + blk0 * 192
                    : coeff + ((long long)c * nblk + blk0) * 64;
    bulk_copy(dst + c * kTB * 64, src, bytes, bar);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
idct_rgb_kernel(const int32_t* __restrict__ coeff, int H, int W,
                const float* __restrict__ quant,
                const int32_t* __restrict__ q_of,
                const int32_t* __restrict__ xf, int interleaved,
                uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int tid = threadIdx.x;
  if (tid < 3 * 64) sm.q[tid] = quant[q_of[tid >> 6] * 64 + (tid & 63)];
  if (tid < 64) sm.nat[tid] = kZigzagToNatural[tid];
  if (tid < 13) sm.xf[tid] = xf[tid];
  if (tid < kStages) bulk_init(&sm.full[tid]);
  bulk_init_fence();
  __syncthreads();
  const int k0 = (tid & 15) * 4;  // this thread's zig-zag positions
  const uchar4 nat = *reinterpret_cast<const uchar4*>(&sm.nat[k0]);
  const int identity = sm.xf[12];
  int m[9], base[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = sm.xf[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) base[i] = sm.xf[9 + i];

  const int nbx = W >> 3, nby = H >> 3;
  const int sx = (nbx + kTB - 1) / kTB;  // strips per block row
  const long long n_strips = (long long)sx * nby;
  const long long nblk = (long long)nbx * nby;
  const int b = tid & 31;  // block of the strip
  const int r = tid >> 5;  // column (column pass), row (row pass)
  auto strip_n = [&](long long s) {
    return min(kTB, nbx - (int)(s % sx) * kTB);
  };
  auto strip_blk0 = [&](long long s) {
    return (s / sx) * nbx + (s % sx) * kTB;
  };
  auto fill = [&](long long i) {  // this CTA's i-th strip into its buffer
    const long long s = blockIdx.x + i * gridDim.x;
    if (tid == 0 && s < n_strips)
      copy_strip(sm.raw[i % kStages], &sm.full[i % kStages], coeff, nblk,
            strip_blk0(s), strip_n(s), interleaved);
  };
  for (int i = 0; i < kStages - 1; ++i) fill(i);

  long long i = 0;
  for (long long s = blockIdx.x; s < n_strips; s += gridDim.x, ++i) {
    fill(i + kStages - 1);  // into the buffer strip i - 1 left
    const int n = strip_n(s);
    const int by = (int)(s / sx), bx0 = (int)(s % sx) * kTB;
    const int stage = (int)(i % kStages);
    bulk_wait(&sm.full[stage], (uint32_t)((i / kStages) & 1));

    // dequantise the strip into the tiles, natural order
    const int per = n * 16;  // units of one component's run
    const int4* raw4 = reinterpret_cast<const int4*>(sm.raw[stage]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = tid + j * kThreads;
      if (u < 3 * per) {
        int c, bb, at;
        if (interleaved) {
          bb = u / 48;
          c = (u - bb * 48) >> 4;
          at = u;
        } else {
          c = u / per;
          bb = (u - c * per) >> 4;
          at = c * kTB * 16 + (u - c * per);
        }
        const int4 x = raw4[at];
        const float4 q = *reinterpret_cast<const float4*>(&sm.q[c * 64 + k0]);
        float* t = sm.tile + (c * kTB + bb) * kTile;
        t[nat.x] = __fmul_rn((float)x.x, q.x);
        t[nat.y] = __fmul_rn((float)x.y, q.y);
        t[nat.z] = __fmul_rn((float)x.z, q.z);
        t[nat.w] = __fmul_rn((float)x.w, q.w);
      }
    }
    __syncthreads();

    // column pass: column r of each component's block b, in place
    if (b < n) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        idct8_col(&sm.tile[(c * kTB + b) * kTile + r]);
    }
    __syncthreads();

    // row pass: row y = r of the three components of block b (8 bytes
    // each, packed), then the colour transform of its 8 pixels, stored
    if (b < n) {
      uint32_t pk[3][2];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint2 v = idct8_row_u8(&sm.tile[(c * kTB + b) * kTile + r * 8]);
        pk[c][0] = v.x;
        pk[c][1] = v.y;
      }
      uint32_t w[6] = {0u, 0u, 0u, 0u, 0u, 0u};  // 24 RGB bytes
#pragma unroll
      for (int px = 0; px < 8; ++px) {
        int y[3], o[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          y[c] = (pk[c][px >> 2] >> (8 * (px & 3))) & 255;
        if (identity) {
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c] = y[c];
        } else {
          int rr[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) rr[c] = ((y[c] - base[c]) * 256) / 255;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int a = m[3 * c] * rr[0] + m[3 * c + 1] * rr[1] +
                          m[3 * c + 2] * rr[2] + 128;
            o[c] = min(max(a >> 8, 0), 255);
          }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int byte = 3 * px + c;
          w[byte >> 2] |= (uint32_t)o[c] << (8 * (byte & 3));
        }
      }
      uint2* dst = reinterpret_cast<uint2*>(
          out + (((size_t)by * 8 + r) * W + (size_t)(bx0 + b) * 8) * 3);
      dst[0] = make_uint2(w[0], w[1]);
      dst[1] = make_uint2(w[2], w[3]);
      dst[2] = make_uint2(w[4], w[5]);
    }
    __syncthreads();  // the tiles are free for the next strip
  }
}

}  // namespace

extern "C" int gj_idct_rgb(const void* coeff, int H, int W, const void* quant,
                           int n_q, const void* q_of, const void* xf,
                           int interleaved, void* out, void* stream) {
  if (n_q < 1 || n_q > 3) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)coeff % 16 || (uintptr_t)out % 8)
    return (int)cudaErrorMisalignedAddress;
  const long long n_strips =
      (long long)((W / 8 + kTB - 1) / kTB) * (H / 8);
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      idct_rgb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_rgb_kernel,
                                                kThreads, smem);
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (ctas > n_strips) ctas = n_strips;
  if (ctas < 1) ctas = 1;
  idct_rgb_kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)coeff, H, W, (const float*)quant,
      (const int32_t*)q_of, (const int32_t*)xf, interleaved, (uint8_t*)out);
  return (int)cudaGetLastError();
}
