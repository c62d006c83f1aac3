// E1p fdct_quant_planes: blockify + separable f32 DCT + quantisation of the
// component planes that E0 (preprocess.cu) writes, in scan order.
//
// Replaces the DCT+quant half of `entropy_v2.block_chunks_dct_fused` (K6)
// of the JAX reference and its staged path's XLA blockify, scan-order
// gather and DCT matmul (`jax_pipeline.py:209-243`); E2 then does the
// entropy half of K6 and the work of K7.
//
// Input: the u8 planes (1 to 4 components, any sampling), the (NB,) scan
// -> plane block map `plan.block_plane_idx`, per plane (byte offset, data
// width, first plane block, blocks per row) and its divisor row. Output:
// int32 coefficients (NB, 64), zig-zag order, row i the plane block
// block_plane_idx[i]: what E2 reads.
//
// What bounds it: bytes (one read of a pixel, four bytes written per
// coefficient); the separable DCT's 2,176 operations a block are well under
// the card's float32 rate. The design is E1's (fdct_quant.cu) over
// scan-order blocks of any plan:
//   * a CTA walks strips of kTB consecutive scan-order blocks (a grid
//     stride). Warp 0 finds each block's plane (a scan of at most 4 first
//     blocks), byte position and row pitch two strips ahead, into a ring
//     of three position sets in shared memory, so no thread divides in the
//     loop;
//   * thread (b, r) loads row r of block b with one 8-byte load (plane
//     offsets are multiples of 64 and data widths of 8, so the load is
//     aligned when the planes are; single bytes otherwise), the next
//     strip's row in flight in registers while the current strip is
//     transformed; in a non-interleaved scan a warp's 32 loads cover 256
//     contiguous bytes;
//   * thread (b, r) runs the row pass of that row in registers into a
//     padded tile per block (65 floats: the lanes of a warp, 32 blocks,
//     hit 32 banks), then thread (b, u) the column pass of column u in
//     place;
//   * the strip's output is one run of 64 * n words in scan order, written
//     with 16-byte stores; a thread's four zig-zag positions are the same in
//     every store, so it reads their natural positions and biases once.
// The divisors, biases and zig-zag table sit in shared memory.
//
// Numerics: E1's exactly (dct8.cuh's `fdct8_row` and `fdct8_col` on the
// raw pixels, one rounded subtraction of the bias, IEEE division
// `__fdiv_rn` by the block's own divisor row, `rintf` half-to-even), so on
// 4:4:4 RGB input E1p on E0's planes equals E1 bit for bit. The plain
// version multiplies by the dense 64x64 operator, so a quotient that lies
// within the float32 error bound of .5 may round differently between the
// two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

constexpr int kTB = 32;            // blocks per strip
constexpr int kThreads = kTB * 8;  // thread (b, r): block b, row/column r
constexpr int kTile = 65;          // floats per block tile
constexpr int kMaxC = 4;           // planes

// the blocks of one strip: plane byte of (0, 0), row pitch, plane
struct Pos {
  int base[kTB];
  int pitch[kTB];
  int comp[kTB];
};

// block i (scan order) into slot b of `p`
__device__ __forceinline__ void locate(Pos& p, int b, long long i,
                                       const int* __restrict__ bpi,
                                       const int* __restrict__ blk, int C) {
  const int pb = bpi[i];
  int c = C - 1;
  while (c > 0 && pb < blk[c * 4 + 2]) --c;
  const int* bp = blk + c * 4;
  const int local = pb - bp[2];
  const int by = local / bp[3], bx = local - by * bp[3];
  p.base[b] = bp[0] + by * 8 * bp[1] + bx * 8;
  p.pitch[b] = bp[1];
  p.comp[b] = c;
}

__device__ __forceinline__ uint2 load_row(const uint8_t* __restrict__ planes,
                                          const Pos& p, int b, int r,
                                          int vec) {
  const uint8_t* q = planes + p.base[b] + r * p.pitch[b];
  if (vec) return *reinterpret_cast<const uint2*>(q);
  return make_uint2(
      q[0] | (q[1] << 8) | (q[2] << 16) | ((uint32_t)q[3] << 24),
      q[4] | (q[5] << 8) | (q[6] << 16) | ((uint32_t)q[7] << 24));
}

__global__ void __launch_bounds__(kThreads, 4)
fdct_quant_planes_kernel(const uint8_t* __restrict__ planes, int vec,
                         const int* __restrict__ bpi, int NB,
                         const int* __restrict__ blk,     // (C, 4)
                         int C,
                         const float* __restrict__ qdiv,  // (C, 64)
                         const float* __restrict__ bias,  // (64,) zig-zag
                         int32_t* __restrict__ out) {
  __shared__ float tile[kTB * kTile];
  __shared__ Pos pos[3];
  __shared__ __align__(16) float s_q[kMaxC * 64];
  __shared__ __align__(16) float s_bias[64];
  __shared__ __align__(16) uint8_t s_nat[64];

  const int tid = threadIdx.x;
  if (tid < C * 64) s_q[tid] = qdiv[tid];
  if (tid < 64) {
    s_bias[tid] = bias[tid];
    s_nat[tid] = kZigzagToNatural[tid];
  }
  const int b = tid & 31;  // block of the strip
  const int r = tid >> 5;  // pixel row (row pass), frequency u (columns)
  const long long n_strips = ((long long)NB + kTB - 1) / kTB;
  auto strip_n = [&](long long s) {
    return (int)min((long long)kTB, (long long)NB - s * kTB);
  };
  // warp 0: the blocks of this CTA's j-th strip into pos[j % 3]
  auto find = [&](long long j) {
    const long long s = blockIdx.x + j * gridDim.x;
    if (tid < kTB && s < n_strips && b < strip_n(s))
      locate(pos[j % 3], b, s * kTB + b, bpi, blk, C);
  };
  find(0);
  find(1);
  __syncthreads();
  // this thread's four zig-zag positions in every 16-byte store
  const int k0 = (tid * 4) & 63;
  const uchar4 nat = *reinterpret_cast<const uchar4*>(&s_nat[k0]);
  const float4 bz = *reinterpret_cast<const float4*>(&s_bias[k0]);

  uint2 next = make_uint2(0u, 0u);
  if (blockIdx.x < n_strips && b < strip_n(blockIdx.x))
    next = load_row(planes, pos[0], b, r, vec);

  long long i = 0;
  for (long long s = blockIdx.x; s < n_strips; s += gridDim.x, ++i) {
    const int n = strip_n(s);
    const uint2 cur = next;
    const long long s1 = s + gridDim.x;
    if (s1 < n_strips && b < strip_n(s1))  // in flight during the arithmetic
      next = load_row(planes, pos[(i + 1) % 3], b, r, vec);

    // row pass: the 8 pixels of row r of block b
    if (b < n) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = (float)(((k < 4 ? cur.x : cur.y) >> (8 * (k & 3))) & 255u);
      fdct8_row(x, &tile[b * kTile + r * 8]);
    }
    __syncthreads();

    // column pass: column u = r of block b, in place; warp 0 finds the
    // blocks of the strip after next
    if (b < n) fdct8_col(&tile[b * kTile + r]);
    find(i + 2);
    __syncthreads();

    // zig-zag gather, bias, quotient by the block's own divisor row;
    // 16-byte stores of the strip's run of 64 * n words
    const Pos& here = pos[i % 3];
    int32_t* dst = out + s * kTB * 64;
    for (int e = tid * 4; e < n * 64; e += kThreads * 4) {
      const int bb = e >> 6;
      const float* t = &tile[bb * kTile];
      const float4 q =
          *reinterpret_cast<const float4*>(&s_q[here.comp[bb] * 64 + k0]);
      int4 o;
      o.x = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.x], bz.x), q.x));
      o.y = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.y], bz.y), q.y));
      o.z = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.z], bz.z), q.z));
      o.w = (int)rintf(__fdiv_rn(__fsub_rn(t[nat.w], bz.w), q.w));
      *reinterpret_cast<int4*>(dst + e) = o;
    }
    __syncthreads();  // the tile and pos[i % 3] are free again
  }
}

}  // namespace

extern "C" int gj_fdct_quant_planes(const void* planes,
                                    const void* block_plane_idx, int NB,
                                    const void* blk, int C, const void* qdiv,
                                    const void* bias, void* out,
                                    void* stream) {
  if (C < 1 || C > kMaxC || NB < 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int vec = (uintptr_t)planes % 8 == 0;
  const long long n_strips = ((long long)NB + kTB - 1) / kTB;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fdct_quant_planes_kernel, kThreads, 0);
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (ctas > n_strips) ctas = n_strips;
  if (ctas > 0)
    fdct_quant_planes_kernel<<<(unsigned)ctas, kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const uint8_t*)planes, vec, (const int*)block_plane_idx, NB,
        (const int*)blk, C, (const float*)qdiv, (const float*)bias,
        (int32_t*)out);
  return (int)cudaGetLastError();
}
