// Bit-field placement and the warp scan shared by the block walk of E2
// and E12 (block_walk.cuh) and by E3 (merge_stuff.cu).
//
// Strings are MSB first in big-endian-in-value 32-bit words: bit offset
// `off` of a string is bit 31 - (off & 31) of word off >> 5. Lanes place
// fields that never overlap, so OR (atomic on shared words) places them in
// any order. Internal linkage, as dct8.cuh: each .cu that includes this
// header keeps its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The low `len` (<= 32) bits of `val`.
__device__ __forceinline__ uint32_t low_bits(uint32_t val, int len) {
  return len < 32 ? val & ((1u << len) - 1u) : val;
}

// OR a field of `len` (1..32) bits at bit offset `off` into the shared row
// of `cap` words: one word or two; words past the row are dropped.
__device__ __forceinline__ void or_field_row(uint32_t* row, int cap, int off,
                                             uint32_t val, int len) {
  const int w = off >> 5;
  const int e = (off & 31) + len;  // end bit within word w's pair
  if (w >= cap) return;
  if (e <= 32) {
    atomicOr(&row[w], val << (32 - e));
  } else {
    atomicOr(&row[w], val >> (e - 32));
    if (w + 1 < cap) atomicOr(&row[w + 1], val << (64 - e));
  }
}

// Inclusive sum of `v` over lanes 0..lane of a full warp.
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

}  // namespace
