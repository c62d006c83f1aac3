// The warp walk of one 8x8 block's Huffman bit string, shared by E2
// (huffman_blocks.cu) and E12 (dct_huffman_blocks.cu).
//
// A warp codes one block. Lane l owns zig-zag coefficients 2l and 2l+1
// and makes, without a branch, the chunk of each of them the way the
// host coder does (golden.encode_block):
//   * lane 0's first chunk is the DC: category code and value bits of the
//     DC difference `dc` (E2 takes it from the predecessor's coefficient,
//     E12 is given it), the code looked up at min(cat, 15);
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
//
// Placement (`place_reg`, `place_row`): a string of at most 64 bits is
// built in registers (each lane ORs its fields into two words, a
// __reduce_or_sync per word joins the lanes); a longer one goes through a
// zeroed row of words in shared memory, into which the lanes atomicOr
// their fields (fields never overlap, so OR places them in any order). A
// row of `cap` words keeps the first 32 cap bits: a field wholly at or
// past bit 32 cap is counted in the length but never placed, a field
// across it loses its tail.
//
// kArith is E12's `lookups` stop mode: the DC and AC symbols' entries
// come from arithmetic (sym * 3 + class, sym = cat for the DC; ZRL and
// EOB from the tables), their fields are not cut to their lengths (a
// field may then be longer than 32 bits and hold more bits than its
// length), and `place_row` puts each by K12's window formula: OR into
// word j = off / 32 shifted left by s0 = 32 - off % 32 - len, or, when
// s0 < 0, right by min(-s0, 31) with the spill shifted left by
// max(32 + s0, 0) into word j + 1. That is the serial WindowSink's
// string: the sink only ORs a field into the words at its offset, so the
// order of the ORs does not matter. For fields that fit their lengths
// the formula is the plain placement.
//
// Strings are MSB first in big-endian-in-value 32-bit words. Codes come
// from the packed tables (`code << 5 | len`, PackedTables) in shared
// memory: `s_ac` (2 x 256) and `s_dc` (2 x 32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_bits.cuh"

namespace {

constexpr unsigned kWalkAll = 0xffffffffu;

// JPEG category (bit length of |v|), 0 for v == 0 (__clz(0) is 32).
__device__ __forceinline__ int category(int v) {
  return 32 - __clz(v < 0 ? -v : v);
}

// The value bits of v (one's complement for negatives: v - 1 agrees with
// v + 2^cat - 1 in the low `cat` bits); callers keep the low `cat` bits.
__device__ __forceinline__ uint32_t value_bits(int v) {
  return (uint32_t)(v - (v < 0));
}

// A lane's chunks of one block and their bit offsets.
struct LaneFields {
  uint32_t sa, sc;  // chunk a's field (the DC in lane 0), chunk c's
  int len_a, len_c;
  int za, zc;       // ZRLs before field a, before field c
  uint32_t zcode;   // the ZRL code, `zl` bits
  int zl;
  int off;          // the lane's first ZRL
  int off_a, off_c;
  int total;        // the block's length, in every lane
  bool zrls;        // some lane has a ZRL (warp-uniform)
};

// The fields of the block whose coefficients 2*lane and 2*lane+1 are
// `v`, of class `k`, with DC difference `dc` (read in lane 0), and the
// scan of their lengths.
template <bool kArith>
__device__ __forceinline__ LaneFields walk_fields(int2 v, int dc, int k,
                                                  int lane, const int* s_ac,
                                                  const int* s_dc) {
  LaneFields f;
  const int* ac = s_ac + k * 256;
  const int z = ac[0xF0];  // ZRL: code << 5 | length
  f.zl = z & 31;
  f.zcode = low_bits((uint32_t)z >> 5, f.zl);
  const unsigned m_lo = __ballot_sync(kWalkAll, v.x != 0);  // coefficient 2l
  const unsigned m_hi = __ballot_sync(kWalkAll, v.y != 0);  // 2l+1
  const unsigned below = (1u << lane) - 1u;
  const unsigned lo_b = m_lo & below, hi_b = m_hi & below;
  // last nonzero coefficient below 2*lane, the DC position as the floor
  const int prev0 = max(lo_b ? 2 * (31 - __clz(lo_b)) : 0,
                        hi_b ? 2 * (31 - __clz(hi_b)) + 1 : 0);
  const int i0 = 2 * lane;

  // chunk a: the DC in lane 0, else coefficient 2l
  const int va = lane == 0 ? dc : v.x;
  const int run_a = i0 - prev0 - 1;
  const int cat_a = category(va);
  const int sym_a = ((run_a & 15) << 4) | cat_a;
  const int ea = lane == 0 ? (kArith ? cat_a * 3 + k
                                     : s_dc[k * 32 + min(cat_a, 15)])
                           : (kArith ? sym_a * 3 + k : ac[sym_a]);
  f.za = (lane != 0 && v.x != 0) ? run_a >> 4 : 0;
  f.len_a = (lane == 0 || v.x != 0) ? (ea & 31) + cat_a : 0;
  const uint32_t fa = ((uint32_t)ea >> 5 << cat_a) |
                      (value_bits(va) & ((1u << cat_a) - 1u));
  f.sa = kArith ? fa : low_bits(fa, f.len_a);
  // chunk c: coefficient 2l+1, or the EOB in lane 31
  const int run_c = i0 - ((lane == 0 || v.x != 0) ? i0 : prev0);
  const int cat_c = category(v.y);
  const int sym_c = ((run_c & 15) << 4) | cat_c;
  const int ec = v.y != 0 ? (kArith ? sym_c * 3 + k : ac[sym_c]) : ac[0];
  f.zc = v.y != 0 ? run_c >> 4 : 0;
  f.len_c = (v.y != 0 || lane == 31) ? (ec & 31) + cat_c : 0;
  const uint32_t fc = ((uint32_t)ec >> 5 << cat_c) |
                      (value_bits(v.y) & ((1u << cat_c) - 1u));
  f.sc = kArith ? fc : low_bits(fc, f.len_c);

  const int len = (f.za + f.zc) * f.zl + f.len_a + f.len_c;
  const int incl = warp_inclusive_scan(len, lane);
  f.total = __shfl_sync(kWalkAll, incl, 31);
  f.off = incl - len;              // the lane's ZRLs of chunk a start here
  f.off_a = f.off + f.za * f.zl;   // chunk a's field
  f.off_c = f.off_a + f.len_a + f.zc * f.zl;
  f.zrls = __any_sync(kWalkAll, (f.za | f.zc) != 0) && f.zl > 0;
  return f;
}

// OR a field of `len` (1..32) bits at bit offset `off` of a string of at
// most 64 bits into its two words (register form).
__device__ __forceinline__ void or_field2(uint32_t& w0, uint32_t& w1, int off,
                                          uint32_t val, int len) {
  const uint64_t win = (uint64_t)val << (64 - off - len);
  w0 |= (uint32_t)(win >> 32);
  w1 |= (uint32_t)win;
}

// Words 0 and 1 of a string of at most 64 bits (fields cut to their
// lengths), in every lane.
__device__ __forceinline__ uint2 place_reg(const LaneFields& f) {
  uint32_t w0 = 0u, w1 = 0u;
  if (f.len_a) or_field2(w0, w1, f.off_a, f.sa, f.len_a);
  if (f.len_c) or_field2(w0, w1, f.off_c, f.sc, f.len_c);
  if (f.zrls) {
    for (int j = 0; j < 3; ++j) {
      if (j < f.za) or_field2(w0, w1, f.off + j * f.zl, f.zcode, f.zl);
      if (j < f.zc)
        or_field2(w0, w1, f.off_a + f.len_a + j * f.zl, f.zcode, f.zl);
    }
  }
  return make_uint2(__reduce_or_sync(kWalkAll, w0),
                    __reduce_or_sync(kWalkAll, w1));
}

// K12's window placement of a field (kArith) into a shared row of `cap`
// words; words past the row are dropped.
__device__ __forceinline__ void or_window_row(uint32_t* row, int cap, int off,
                                              uint32_t val, int len) {
  const int j = off >> 5;
  if (j >= cap) return;
  const int s0 = 32 - (off & 31) - len;
  if (s0 >= 0) {
    atomicOr(&row[j], val << s0);
  } else {
    atomicOr(&row[j], val >> min(-s0, 31));
    const uint32_t hi = val << max(32 + s0, 0);
    if (j + 1 < cap && hi) atomicOr(&row[j + 1], hi);
  }
}

// OR the lane's fields into the zeroed shared row of `cap` words.
template <bool kArith>
__device__ __forceinline__ void place_row(uint32_t* row, int cap,
                                          const LaneFields& f) {
  if (f.len_a) {
    if (kArith) or_window_row(row, cap, f.off_a, f.sa, f.len_a);
    else or_field_row(row, cap, f.off_a, f.sa, f.len_a);
  }
  if (f.len_c) {
    if (kArith) or_window_row(row, cap, f.off_c, f.sc, f.len_c);
    else or_field_row(row, cap, f.off_c, f.sc, f.len_c);
  }
  if (f.zrls) {
    for (int j = 0; j < 3; ++j) {
      if (j < f.za) or_field_row(row, cap, f.off + j * f.zl, f.zcode, f.zl);
      if (j < f.zc)
        or_field_row(row, cap, f.off_a + f.len_a + j * f.zl, f.zcode, f.zl);
    }
  }
}

}  // namespace
