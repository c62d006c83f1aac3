// E3 merge_stuff: per-segment merge of the block bit strings, 1-bit padding,
// 0xFF -> 0xFF00 byte stuffing and RST marker append.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stage 6 (`_merge_stuff_core` tree merge + `_stuff_core` stuffing and RST).
//
// One thread per restart segment. The thread walks its segment's blocks in
// order; the running bit count is the exclusive scan of the block bit
// lengths, so every block string lands right after the previous one. Bits
// move through a 64-bit accumulator and leave as bytes; a 0xFF byte is
// followed by a stuffed 0x00 as it is written. The last byte is padded with
// 1-bits (T.81 F.1.2.3, as golden.BitWriter.flush), and `0xFF, rst` follows
// where `has_rst` is set (every segment but the last of its scan).
//
// Output per segment s: bytes in out[s, :out_len[s]] (the rest of the row
// is not written), seg_bits[s] = raw bits before padding, n_ff[s] = 0xFF
// bytes stuffed. The row capacity `cap_out` is the worst case (every byte
// stuffed, plus the marker), so no segment can overflow it.
//
// What bounds it: bytes and divergence. Each thread reads its blocks' words
// and writes its segment's bytes one at a time into its own row; threads of
// a warp touch rows `cap_out` bytes apart, and segment lengths differ.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void merge_stuff_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ bits,
                                   int cap_words,
                                   const int32_t* __restrict__ seg_start,
                                   const int32_t* __restrict__ seg_count,
                                   const int32_t* __restrict__ rst,
                                   const int32_t* __restrict__ has_rst,
                                   int n_seg, int cap_out,
                                   uint8_t* __restrict__ out,
                                   int32_t* __restrict__ out_len,
                                   int32_t* __restrict__ seg_bits,
                                   int32_t* __restrict__ n_ff) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;
  uint8_t* o = out + (size_t)s * cap_out;
  int pos = 0, nff = 0, total = 0;
  uint64_t acc = 0;
  int nbits = 0;

  auto emit = [&](uint32_t byte) {
    o[pos++] = (uint8_t)byte;
    if (byte == 0xFF) {
      o[pos++] = 0;
      ++nff;
    }
  };

  const int first = seg_start[s], end = first + seg_count[s];
  for (int b = first; b < end; ++b) {
    int left = bits[b];
    total += left;
    const uint32_t* w = words + (size_t)b * cap_words;
    for (int i = 0; left > 0; ++i) {
      const int take = left < 32 ? left : 32;
      acc = (acc << take) | (uint64_t)(w[i] >> (32 - take));
      nbits += take;
      left -= take;
      while (nbits >= 8) {
        nbits -= 8;
        emit((uint32_t)(acc >> nbits) & 0xFFu);
      }
      acc &= (1ull << nbits) - 1ull;
    }
  }
  if (nbits > 0) {
    const int pad = 8 - nbits;
    emit((uint32_t)((acc << pad) | ((1u << pad) - 1u)) & 0xFFu);
  }
  if (has_rst[s]) {
    o[pos++] = 0xFF;
    o[pos++] = (uint8_t)rst[s];
  }
  out_len[s] = pos;
  seg_bits[s] = total;
  n_ff[s] = nff;
}

}  // namespace

extern "C" int gj_merge_stuff(const void* words, const void* bits,
                              int cap_words, const void* seg_start,
                              const void* seg_count, const void* rst,
                              const void* has_rst, int n_seg, int cap_out,
                              void* out, void* out_len, void* seg_bits,
                              void* n_ff, void* stream) {
  const int threads = 128;
  const int ctas = (n_seg + threads - 1) / threads;
  if (ctas > 0)
    merge_stuff_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)bits, cap_words,
        (const int32_t*)seg_start, (const int32_t*)seg_count,
        (const int32_t*)rst, (const int32_t*)has_rst, n_seg, cap_out,
        (uint8_t*)out, (int32_t*)out_len, (int32_t*)seg_bits,
        (int32_t*)n_ff);
  return (int)cudaGetLastError();
}
