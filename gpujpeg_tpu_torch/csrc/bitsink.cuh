// The per-thread bit writer of E12 (dct_huffman_blocks.cu) and the two
// JPEG value helpers it shares with E2 (huffman_blocks.cu).
//
// BitSink gathers bits MSB first in a 64-bit accumulator and writes them
// out as big-endian-in-value 32-bit words, at most `cap_words` of them;
// `total` counts every bit put, so a string cut at the capacity still
// reports its full length.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct BitSink {
  uint32_t* out;
  int cap_words;
  uint64_t acc = 0;
  int nbits = 0;   // bits waiting in acc (< 32 between calls)
  int nwords = 0;  // words written
  int total = 0;   // bits put

  // Append the low `len` bits of `value` (0 <= len < 32).
  __device__ void put(uint32_t value, int len) {
    if (len == 0) return;
    acc = (acc << len) | (value & ((1u << len) - 1u));
    nbits += len;
    total += len;
    while (nbits >= 32) {
      nbits -= 32;
      if (nwords < cap_words) out[nwords] = (uint32_t)(acc >> nbits);
      ++nwords;
    }
    acc &= (1ull << nbits) - 1ull;
  }

  // Write the last partial word, zero-padded on the right.
  __device__ void flush() {
    if (nbits > 0 && nwords < cap_words)
      out[nwords] = (uint32_t)(acc << (32 - nbits));
  }
};

// JPEG category (bit length of |v|), 0 for v == 0 (__clz(0) is 32).
__device__ __forceinline__ int category(int v) {
  return 32 - __clz(v < 0 ? -v : v);
}

// The value bits of v (one's complement for negatives: v - 1 agrees with
// v + 2^cat - 1 in the low `cat` bits); callers keep the low `cat` bits.
__device__ __forceinline__ uint32_t value_bits(int v) {
  return (uint32_t)(v - (v < 0));
}
