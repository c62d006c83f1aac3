// E2 huffman_blocks: DC prediction, symbol synthesis, Annex-K code lookup
// and the bit string of every block.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stages 3-5 (DC prediction, `_chunk_planes_lanes` symbol synthesis and
// code lookup, per-block bit strings).
//
// One thread per 8x8 block. The thread walks the block's 64 zig-zag
// coefficients the way the host coder does (golden.encode_block): DC
// category and value bits, then for every nonzero AC coefficient any ZRL
// codes for runs above 15, the (run, size) code and the value bits, and an
// EOB when the block ends in zeros. Codes come from the packed tables
// (`code << 5 | len`, PackedTables). Bits gather MSB first in a 64-bit
// accumulator and leave as 32-bit words into the block's row of the
// scratch, which has one worst-case capacity for every block, so no block
// can overflow it (64 chunks of at most 27 bits fit in 56 words).
//
// The DC predecessor (`dc_pred[b]`, -1 at a segment start or for the first
// block of a component in an MCU chain) is another block's coefficient: it
// is read from the coefficient array in device memory, never from another
// thread's registers.
//
// What bounds it: bytes and divergence. Each thread reads its 256-byte
// coefficient row and writes a few words of bits; the per-coefficient
// branches differ between the threads of a warp with the content.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsink.cuh"

namespace {

__global__ void huffman_blocks_kernel(const int32_t* __restrict__ coeff,
                                      int n_blocks,
                                      const int32_t* __restrict__ dc_pred,
                                      const int32_t* __restrict__ cls,
                                      const int32_t* __restrict__ ac512,
                                      const int32_t* __restrict__ dc64,
                                      int cap_words,
                                      uint32_t* __restrict__ words,
                                      int32_t* __restrict__ bits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int32_t* c = coeff + (size_t)b * 64;
  const int k = cls[b];
  const int32_t* ac = ac512 + k * 256;
  BitSink sink{words + (size_t)b * cap_words, cap_words};

  const int pred = dc_pred[b];
  const int diff = c[0] - (pred >= 0 ? coeff[(size_t)pred * 64] : 0);
  int cat = category(diff);
  int e = dc64[k * 32 + cat];
  sink.put((((uint32_t)e >> 5) << cat) | (value_bits(diff, cat) & ((1u << cat) - 1u)),
           (e & 31) + cat);

  int run = 0;
  for (int i = 1; i < 64; ++i) {
    const int v = c[i];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) {
      const int z = ac[0xF0];
      sink.put((uint32_t)z >> 5, z & 31);
    }
    cat = category(v);
    e = ac[(run << 4) | cat];
    sink.put((((uint32_t)e >> 5) << cat) | (value_bits(v, cat) & ((1u << cat) - 1u)),
             (e & 31) + cat);
    run = 0;
  }
  if (run > 0) sink.put((uint32_t)ac[0] >> 5, ac[0] & 31);
  sink.flush();
  bits[b] = sink.total;
}

}  // namespace

extern "C" int gj_huffman_blocks(const void* coeff, int n_blocks,
                                 const void* dc_pred, const void* cls,
                                 const void* ac512, const void* dc64,
                                 int cap_words, void* words, void* bits,
                                 void* stream) {
  const int threads = 128;
  const int ctas = (n_blocks + threads - 1) / threads;
  if (ctas > 0)
    huffman_blocks_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)coeff, n_blocks, (const int32_t*)dc_pred,
        (const int32_t*)cls, (const int32_t*)ac512, (const int32_t*)dc64,
        cap_words, (uint32_t*)words, (int32_t*)bits);
  return (int)cudaGetLastError();
}
