// E2 huffman_blocks: DC prediction, symbol synthesis, Annex-K code lookup
// and the bit string of every block.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stages 3-5 (DC prediction, `_chunk_planes_lanes` symbol synthesis and
// code lookup, per-block bit strings), and `block_chunks_pallas` (K7).
//
// One warp per 8x8 block, the warps persistent (a grid stride over the
// blocks). Lane l owns zig-zag coefficients 2l and 2l+1, loaded as one
// int2, so the warp reads the block's 256 bytes in one coalesced pass;
// the next block's coefficients, class and DC predecessor are loaded
// while the current one is coded. The walk itself (chunks, ballot run
// lengths, the scan, the placement) is block_walk.cuh's, shared with E12
// (dct_huffman_blocks.cu); E2 gives it the difference to the
// predecessor's DC (`dc_pred[b]`, -1 at a segment start or for the first
// block of a component in an MCU chain; it is another block's
// coefficient, read from the coefficient array in device memory, never
// from another lane). A block of at most 64 bits (most blocks of a photo
// at Q75) is built in registers and lanes 0 and 1 store its words; a
// longer one goes through the warp's zeroed 56-word row in shared memory,
// whose first ceil(bits/32) words the warp stores to the block's row of
// the output in one coalesced pass and zeroes again for the next block.
// Either way the block's row holds its string MSB first in
// big-endian-in-value words, the last word zero-padded. The tables are
// staged once per CTA in shared memory.
//
// What bounds it: bytes in the bound (the coefficients read once), the
// issue of warp instructions in practice: a block costs the same fixed
// sequence (ballots, scan, reductions or the shared row) whatever its
// content, and the lanes' branch-free chunk arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_walk.cuh"

namespace {

constexpr int kWarps = 32;         // warps per CTA
constexpr int kCap = 56;           // words of a block's row (BLOCK_CAP_WORDS)

__device__ __forceinline__ int2 load_pair(const int32_t* coeff, int b,
                                          int lane) {
  return reinterpret_cast<const int2*>(coeff + (size_t)b * 64)[lane];
}

// Code block b, whose coefficients 2*lane and 2*lane+1 are `v`, of class
// `k`, with predecessor DC `pdc`.
__device__ __forceinline__ void code_block(int b, int2 v, int k, int pdc,
                                           int lane, const int* s_ac,
                                           const int* s_dc, uint32_t* row,
                                           uint32_t* __restrict__ words,
                                           int32_t* __restrict__ bits) {
  const LaneFields f = walk_fields<false>(v, v.x - pdc, k, lane, s_ac, s_dc);
  if (f.total <= 64) {  // warp-uniform
    const uint2 w = place_reg(f);
    if (lane < ((f.total + 31) >> 5))
      words[(size_t)b * kCap + lane] = lane ? w.y : w.x;
  } else {
    place_row<false>(row, kCap, f);
    __syncwarp();
    const int n_words = min((f.total + 31) >> 5, kCap);
    uint32_t* dst = words + (size_t)b * kCap;
    for (int w = lane; w < n_words; w += 32) {
      dst[w] = row[w];
      row[w] = 0u;
    }
    __syncwarp();
  }
  if (lane == 0) bits[b] = f.total;
}

__global__ void __launch_bounds__(kWarps * 32)
huffman_blocks_kernel(const int32_t* __restrict__ coeff, int n_blocks,
                      const int32_t* __restrict__ dc_pred,
                      const int32_t* __restrict__ cls,
                      const int32_t* __restrict__ ac512,
                      const int32_t* __restrict__ dc64,
                      uint32_t* __restrict__ words,
                      int32_t* __restrict__ bits) {
  __shared__ int s_ac[512];
  __shared__ int s_dc[64];
  __shared__ uint32_t s_row[kWarps][kCap];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) s_ac[i] = ac512[i];
  if (threadIdx.x < 64) s_dc[threadIdx.x] = dc64[threadIdx.x];
  for (int i = threadIdx.x; i < kWarps * kCap; i += blockDim.x)
    s_row[i / kCap][i % kCap] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  int b = blockIdx.x * kWarps + warp;
  // block b's operands in registers; block b + stride's predecessor index
  int2 v = make_int2(0, 0);
  int k = 0, pdc = 0, pidx_next = -1;
  if (b < n_blocks) {
    v = load_pair(coeff, b, lane);
    k = cls[b];
    const int p = dc_pred[b];
    pdc = p >= 0 ? coeff[(size_t)p * 64] : 0;
    if (b + stride < n_blocks) pidx_next = dc_pred[b + stride];
  }
  for (; b < n_blocks; b += stride) {
    const int bn = b + stride;
    int2 vn = make_int2(0, 0);
    int kn = 0, pdcn = 0, pidx_nn = -1;
    if (bn < n_blocks) {  // warp-uniform
      vn = load_pair(coeff, bn, lane);
      kn = cls[bn];
      pdcn = pidx_next >= 0 ? coeff[(size_t)pidx_next * 64] : 0;
      if (bn + stride < n_blocks) pidx_nn = dc_pred[bn + stride];
    }
    code_block(b, v, k, pdc, lane, s_ac, s_dc, s_row[warp], words, bits);
    v = vn;
    k = kn;
    pdc = pdcn;
    pidx_next = pidx_nn;
  }
}

}  // namespace

extern "C" int gj_huffman_blocks(const void* coeff, int n_blocks,
                                 const void* dc_pred, const void* cls,
                                 const void* ac512, const void* dc64,
                                 int cap_words, void* words, void* bits,
                                 void* stream) {
  if (cap_words != kCap) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, huffman_blocks_kernel, kWarps * 32, 0);
  long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n_blocks + kWarps - 1) / kWarps;
  if (ctas > need) ctas = need;
  if (ctas < 1) ctas = 1;
  huffman_blocks_kernel<<<(unsigned)ctas, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)coeff, n_blocks, (const int32_t*)dc_pred,
      (const int32_t*)cls, (const int32_t*)ac512, (const int32_t*)dc64,
      (uint32_t*)words, (int32_t*)bits);
  return (int)cudaGetLastError();
}
