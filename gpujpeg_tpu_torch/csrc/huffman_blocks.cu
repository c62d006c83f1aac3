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
// while the current one is coded. Each lane makes, without a branch, the
// chunk of each of its coefficients the way the host coder does
// (golden.encode_block):
//   * lane 0's first chunk is the DC: category code and value bits of the
//     difference to the predecessor's DC (`dc_pred[b]`, -1 at a segment
//     start or for the first block of a component in an MCU chain; it is
//     another block's coefficient, read from the coefficient array in
//     device memory, never from another lane);
//   * a nonzero AC coefficient i gives `run >> 4` ZRL codes, the
//     `(run & 15, cat)` code and `cat` value bits, where `run` counts the
//     zeros since the previous nonzero coefficient. That one comes from
//     two __ballot_sync masks (bit l: coefficient 2l, resp. 2l+1, is
//     nonzero) and a count of leading zeros below the lane, with the DC
//     position as the floor;
//   * lane 31's second chunk is the EOB when coefficient 63 is zero (the
//     same formula: symbol 0x00, no value bits).
// A chunk is at most three ZRLs of up to 16 bits each, then one field of
// at most 32 bits (a code of up to 16 bits and the value bits); ZRLs are
// placed in a pass of their own that a warp takes only when one of its
// lanes has a run over 15. An inclusive __shfl_up_sync scan of the lanes'
// lengths gives each lane its bit offset and the block its length.
//   * A block of at most 64 bits (most blocks of a photo at Q75) is built
//     in registers: each lane ORs its fields into two words, a
//     __reduce_or_sync per word joins the lanes, lanes 0 and 1 store them.
//   * A longer block goes through the warp's zeroed 56-word row in shared
//     memory: the lanes atomicOr their fields into it (fields never
//     overlap, so OR places them), store its first ceil(bits/32) words to
//     the block's row of the output in one coalesced pass and zero them
//     again for the next block.
// Either way the block's row holds its string MSB first in
// big-endian-in-value words, the last word zero-padded. Codes come from
// the packed tables (`code << 5 | len`, PackedTables), staged once per
// CTA in shared memory.
//
// What bounds it: bytes in the bound (the coefficients read once), the
// issue of warp instructions in practice: a block costs the same fixed
// sequence (ballots, scan, reductions or the shared row) whatever its
// content, and the lanes' branch-free chunk arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsink.cuh"
#include "warp_bits.cuh"

namespace {

constexpr int kWarps = 32;         // warps per CTA
constexpr int kCap = 56;           // words of a block's row (BLOCK_CAP_WORDS)
constexpr unsigned kAll = 0xffffffffu;

// OR a field of `len` (1..32) bits at bit offset `off` of a string of at
// most 64 bits into its two words (register form).
__device__ __forceinline__ void or_field2(uint32_t& w0, uint32_t& w1, int off,
                                          uint32_t val, int len) {
  const uint64_t win = (uint64_t)val << (64 - off - len);
  w0 |= (uint32_t)(win >> 32);
  w1 |= (uint32_t)win;
}

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
  const int* ac = s_ac + k * 256;
  const int z = ac[0xF0];  // ZRL: code << 5 | length
  const int zl = z & 31;
  const uint32_t zcode = low_bits((uint32_t)z >> 5, zl);
  const unsigned m_lo = __ballot_sync(kAll, v.x != 0);  // coefficient 2l
  const unsigned m_hi = __ballot_sync(kAll, v.y != 0);  // coefficient 2l+1
  const unsigned below = (1u << lane) - 1u;
  const unsigned lo_b = m_lo & below, hi_b = m_hi & below;
  // last nonzero coefficient below 2*lane, the DC position as the floor
  const int prev0 = max(lo_b ? 2 * (31 - __clz(lo_b)) : 0,
                        hi_b ? 2 * (31 - __clz(hi_b)) + 1 : 0);
  const int i0 = 2 * lane;

  // chunk a: the DC in lane 0, else coefficient 2l
  const int va = lane == 0 ? v.x - pdc : v.x;
  const int run_a = i0 - prev0 - 1;
  const int cat_a = category(va);
  const int ea = lane == 0 ? s_dc[k * 32 + min(cat_a, 15)]
                           : ac[((run_a & 15) << 4) | cat_a];
  const int za = (lane != 0 && v.x != 0) ? run_a >> 4 : 0;
  const int len_a = (lane == 0 || v.x != 0) ? (ea & 31) + cat_a : 0;
  const uint32_t sa = low_bits(((uint32_t)ea >> 5 << cat_a) |
                               (value_bits(va) & ((1u << cat_a) - 1u)),
                               len_a);
  // chunk c: coefficient 2l+1, or the EOB in lane 31
  const int run_c = i0 - ((lane == 0 || v.x != 0) ? i0 : prev0);
  const int cat_c = category(v.y);
  const int ec = ac[v.y != 0 ? ((run_c & 15) << 4) | cat_c : 0];
  const int zc = v.y != 0 ? run_c >> 4 : 0;
  const int len_c = (v.y != 0 || lane == 31) ? (ec & 31) + cat_c : 0;
  const uint32_t sc = low_bits(((uint32_t)ec >> 5 << cat_c) |
                               (value_bits(v.y) & ((1u << cat_c) - 1u)),
                               len_c);

  const int len = (za + zc) * zl + len_a + len_c;
  const int incl = warp_inclusive_scan(len, lane);
  const int total = __shfl_sync(kAll, incl, 31);
  const int off = incl - len;        // the lane's ZRLs of chunk a start here
  const int off_a = off + za * zl;   // chunk a's field
  const int off_c = off_a + len_a + zc * zl;
  const bool zrls = __any_sync(kAll, (za | zc) != 0) && zl > 0;

  if (total <= 64) {  // warp-uniform
    uint32_t w0 = 0u, w1 = 0u;
    if (len_a) or_field2(w0, w1, off_a, sa, len_a);
    if (len_c) or_field2(w0, w1, off_c, sc, len_c);
    if (zrls) {
      for (int j = 0; j < 3; ++j) {
        if (j < za) or_field2(w0, w1, off + j * zl, zcode, zl);
        if (j < zc) or_field2(w0, w1, off_a + len_a + j * zl, zcode, zl);
      }
    }
    w0 = __reduce_or_sync(kAll, w0);
    w1 = __reduce_or_sync(kAll, w1);
    if (lane < ((total + 31) >> 5)) words[(size_t)b * kCap + lane] =
        lane ? w1 : w0;
  } else {
    if (len_a) or_field_row(row, kCap, off_a, sa, len_a);
    if (len_c) or_field_row(row, kCap, off_c, sc, len_c);
    if (zrls) {
      for (int j = 0; j < 3; ++j) {
        if (j < za) or_field_row(row, kCap, off + j * zl, zcode, zl);
        if (j < zc) or_field_row(row, kCap, off_a + len_a + j * zl, zcode, zl);
      }
    }
    __syncwarp();
    const int n_words = min((total + 31) >> 5, kCap);
    uint32_t* dst = words + (size_t)b * kCap;
    for (int w = lane; w < n_words; w += 32) {
      dst[w] = row[w];
      row[w] = 0u;
    }
    __syncwarp();
  }
  if (lane == 0) bits[b] = total;
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
