// D2p idct_planes: dequantisation + separable f32 IDCT + unblockify of
// scan-order zig-zag coefficients into the MCU-padded u8 component planes,
// for any plan (any sampling, interleaved or not, 1 to 4 components).
//
// Replaces the XLA plan tail of the JAX reference after K4 (`run_raw`) or
// K5: the scan -> plane gather (`jax_pipeline.py:1156`), and per component
// `dct.dequant_idct_device` and `blocks.blocks_to_plane`
// (`jax_pipeline.py:1158-1184`). D3 (postprocess.cu) then packs the raw
// frame.
//
// Input: coefficients (NB, 64) int32 in scan order (D1's output), 16-byte
// aligned; `quant` (n_q, 64) f32 zig-zag quantisation tables, n_q <= 4;
// `q_of[C]` each plane's table; per plane (byte offset, data width, first
// plane block, blocks per row); the (NB,) scan -> plane block map
// `plan.block_plane_idx`. Output: the planes, concatenated in component
// order, each (data_height, data_width) row-major: E0's layout, what D3
// reads.
//
// What bounds it: bytes (four bytes read per coefficient, one written per
// value); the separable IDCT's 2,176 operations a block are well under the
// card's float32 rate. The design is D2's (idct_rgb.cu) over scan-order
// blocks of any plan:
//   * a CTA walks strips of kTB consecutive scan-order blocks (a grid
//     stride). A strip's coefficients are one run of 256 * n bytes, so one
//     thread copies them into a ring of kStages shared buffers with a bulk
//     copy (`cp.async.bulk`, bulk_ring.cuh), completed on an mbarrier per
//     buffer; two strips are in flight while one is transformed;
//   * warp 0 finds each block's plane (a scan of at most 4 first blocks),
//     byte position and row pitch one strip ahead, into one of two
//     position sets in shared memory, so no thread divides in the loop;
//   * the CTA dequantises the strip by each block's own table into a
//     padded tile per block in natural order (65 floats: the lanes of a
//     warp, 32 blocks, hit 32 banks); a thread's four zig-zag positions are
//     the same in every 16-byte unit, so it reads their natural positions
//     once;
//   * thread (b, u) runs the column pass of column u of block b in place,
//     then thread (b, y) the row pass of row y, and writes its 8 pixels with
//     one 8-byte store at the block's plane position; in a non-interleaved
//     scan a warp writes 256 contiguous bytes.
//
// Numerics: D2's exactly: per value X_k = x_k * q_k (one rounded multiply),
// dct8.cuh's `idct8_col` and `idct8_row_u8` (each 8-point sum split into its
// even and odd terms, fmaf in index order from 0, out[j] = E + O and out[7 -
// j] = E - O), then + 128 (one rounding), rintf (half to even) and a clamp
// to [0, 255]. So on 4:4:4 input, D2p followed by D3 to RGB equals D2 bit
// for bit. The plain version multiplies by the dense 64x64 operator, so a
// value that lies within the float32 error bound of .5 may round
// differently between the two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"
#include "dct8.cuh"

namespace {

constexpr int kTB = 32;               // blocks per strip
constexpr int kThreads = kTB * 8;     // thread (b, r): block b, column/row r
constexpr int kTile = 65;             // floats per block tile
constexpr int kStrip = kTB * 64;      // coefficients of a strip
constexpr int kPer = kStrip / 4 / kThreads;  // 16-byte units per thread
constexpr int kStages = 3;            // ring buffers: two strips in flight
constexpr int kMaxC = 4;              // planes

struct __align__(16) Smem {
  int32_t raw[kStages][kStrip];  // bulk-copy ring, scan order
  float tile[kTB * kTile];
  float q[kMaxC * 64];           // each plane's table
  uint64_t full[kStages];        // mbarriers: a buffer's copy landed
  int base[2][kTB];              // a block's plane byte of (0, 0)
  int pitch[2][kTB];             // its plane's data width
  int comp[2][kTB];              // its plane
  uint8_t nat[64];
};

__global__ void __launch_bounds__(kThreads, 4)
idct_planes_kernel(const int32_t* __restrict__ coeff, int NB,
                   const float* __restrict__ quant,
                   const int32_t* __restrict__ q_of,
                   const int32_t* __restrict__ blk,  // (C, 4)
                   int C, const int32_t* __restrict__ bpi,
                   uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int tid = threadIdx.x;
  if (tid < C * 64) sm.q[tid] = quant[q_of[tid >> 6] * 64 + (tid & 63)];
  if (tid < 64) sm.nat[tid] = kZigzagToNatural[tid];
  if (tid < kStages) bulk_init(&sm.full[tid]);
  bulk_init_fence();

  const long long n_strips = ((long long)NB + kTB - 1) / kTB;
  const int b = tid & 31;  // block of the strip
  const int r = tid >> 5;  // column (column pass), row (row pass)
  auto strip_n = [&](long long s) {
    return (int)min((long long)kTB, (long long)NB - s * kTB);
  };
  // warp 0: the blocks of this CTA's j-th strip into position set j % 2
  auto find = [&](long long j) {
    const long long s = blockIdx.x + j * gridDim.x;
    if (tid >= kTB || s >= n_strips || b >= strip_n(s)) return;
    const int pb = bpi[s * kTB + b];
    int c = C - 1;
    while (c > 0 && pb < blk[c * 4 + 2]) --c;
    const int* bp = blk + c * 4;
    const int local = pb - bp[2];
    const int by = local / bp[3], bx = local - by * bp[3];
    sm.base[j & 1][b] = bp[0] + by * 8 * bp[1] + bx * 8;
    sm.pitch[j & 1][b] = bp[1];
    sm.comp[j & 1][b] = c;
  };
  // one thread: this CTA's j-th strip into its buffer
  auto fill = [&](long long j) {
    const long long s = blockIdx.x + j * gridDim.x;
    if (tid != 0 || s >= n_strips) return;
    const uint32_t bytes = (uint32_t)strip_n(s) * 256u;
    uint64_t* bar = &sm.full[j % kStages];
    bulk_expect(bar, bytes);
    bulk_copy(sm.raw[j % kStages], coeff + s * kStrip, bytes, bar);
  };
  find(0);
  __syncthreads();
  const int k0 = (tid & 15) * 4;  // this thread's zig-zag positions
  const uchar4 nat = *reinterpret_cast<const uchar4*>(&sm.nat[k0]);
  for (int j = 0; j < kStages - 1; ++j) fill(j);

  long long i = 0;
  for (long long s = blockIdx.x; s < n_strips; s += gridDim.x, ++i) {
    fill(i + kStages - 1);  // into the buffer strip i - 1 left
    const int n = strip_n(s);
    const int stage = (int)(i % kStages), set = (int)(i & 1);
    bulk_wait(&sm.full[stage], (uint32_t)((i / kStages) & 1));

    // dequantise the strip into the tiles by each block's own table
    const int4* raw4 = reinterpret_cast<const int4*>(sm.raw[stage]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = tid + j * kThreads;
      if (u < n * 16) {
        const int bb = u >> 4;
        const int4 x = raw4[u];
        const float4 q = *reinterpret_cast<const float4*>(
            &sm.q[sm.comp[set][bb] * 64 + k0]);
        float* t = sm.tile + bb * kTile;
        t[nat.x] = __fmul_rn((float)x.x, q.x);
        t[nat.y] = __fmul_rn((float)x.y, q.y);
        t[nat.z] = __fmul_rn((float)x.z, q.z);
        t[nat.w] = __fmul_rn((float)x.w, q.w);
      }
    }
    __syncthreads();

    // column pass: column r of block b, in place; warp 0 finds the blocks
    // of the next strip
    if (b < n) idct8_col(&sm.tile[b * kTile + r]);
    find(i + 1);
    __syncthreads();

    // row pass: row y = r of block b, stored at its plane position
    if (b < n)
      *reinterpret_cast<uint2*>(out + sm.base[set][b] +
                                r * sm.pitch[set][b]) =
          idct8_row_u8(&sm.tile[b * kTile + r * 8]);
    __syncthreads();  // the tile and position set `set` are free again
  }
}

}  // namespace

extern "C" int gj_idct_planes(const void* coeff, int NB, const void* quant,
                              int n_q, const void* q_of, const void* blk,
                              int C, const void* block_plane_idx, void* out,
                              void* stream) {
  if (n_q < 1 || n_q > kMaxC || C < 1 || C > kMaxC || NB < 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)coeff % 16 || (uintptr_t)out % 8)
    return (int)cudaErrorMisalignedAddress;
  const long long n_strips = ((long long)NB + kTB - 1) / kTB;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      idct_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_planes_kernel,
                                                kThreads, smem);
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (ctas > n_strips) ctas = n_strips;
  if (ctas > 0)
    idct_planes_kernel<<<(unsigned)ctas, kThreads, smem,
                         (cudaStream_t)stream>>>(
        (const int32_t*)coeff, NB, (const float*)quant,
        (const int32_t*)q_of, (const int32_t*)blk, C,
        (const int32_t*)block_plane_idx, (uint8_t*)out);
  return (int)cudaGetLastError();
}
