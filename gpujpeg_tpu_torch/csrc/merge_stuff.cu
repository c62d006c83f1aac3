// E3 merge_stuff: per-segment merge of the block bit strings, 1-bit padding,
// 0xFF -> 0xFF00 byte stuffing and RST marker append.
//
// Replaces `entropy_v2.encode_dct_fused_full` (K1) of the JAX reference,
// stage 6 (`_merge_stuff_core` tree merge + `_stuff_core` stuffing and RST),
// and on the general route `merge_stuff_packed` (K8), `merge_segments_packed`
// (K9), `merge_segments_pallas` (K10) and `stuff_and_rst_pallas` (K11).
//
// One warp per restart segment (GPUJPEG's encoder serialises a segment with
// a warp too), 16 warps a CTA. A segment is walked in steps of up to 32
// blocks, lane j taking block b0 + j:
//   * an inclusive warp scan of the block bit lengths gives each block its
//     bit offset in the warp's window of kWin words in shared memory; the
//     step takes the blocks whose strings end inside the window (all 32 on
//     the main path; at least one, since a block's row of `cap_words`
//     words fits in any window);
//   * each lane ORs its block's words into the window (shared atomics:
//     fields never overlap, so the result does not depend on their order);
//   * the lanes take the window's whole words, count their 0xFF bytes, and
//     an exclusive scan of (4 + count) gives each word its place in the
//     segment's output row, where the lane writes its bytes, each 0xFF
//     followed by a stuffed 0x00;
//   * the partial last word (< 32 bits) stays in a register as the carry
//     that the next step's offsets start after, and the used words are
//     zeroed again.
// After the last step lane 0 pads the carry with 1-bits to a byte (T.81
// F.1.2.3, as golden.BitWriter.flush), writes its bytes with stuffing, and
// `0xFF, rst` where `has_rst` is set (every segment but the last of its
// scan).
//
// Output per segment s: bytes in out[s, :out_len[s]] (the rest of the row
// is not written), seg_bits[s] = raw bits before padding, n_ff[s] = 0xFF
// bytes stuffed. The row capacity `cap_out` is the worst case (every byte
// stuffed, plus the marker), so no segment can overflow it. A block's bit
// length must not exceed 32 * cap_words (E2's and E12's strings at
// BLOCK_CAP_WORDS hold it); a longer one is read as cut at its row.
//
// What bounds it: bytes in the bound (the used words read once, the bytes
// written once); in practice the reads of the blocks' words. A lane's
// first word lies in its own row of 224 bytes, so each load instruction of
// the warp touches 32 sectors. On the main path at 8K (NVIDIA H100 80GB
// HBM3, 700.00 W, one call, CUDA events with the runs held behind a spin
// of the card, `tools.mean_ms(hold=True)`) the kernel with its warps
// persistent in a grid stride took 0.0617 ms against the thread-per-segment
// kernel's 0.1072; cut to its loads (no window, no stuffing) 0.0568, with
// its byte stores replaced by an XOR 0.0586, with the word loads and the
// window replaced by an XOR of the offsets 0.0268: the word reads are about
// 0.035 ms of it. Forms that lost in that call: the next segment's bounds,
// bit lengths and first words loaded ahead 0.0700 (40 registers and
// spills: 3 CTAs an SM), the same held to 32 registers 0.0873, 8 or 32
// warps a CTA 0.0614, 0.0631; one warp a segment and no grid stride, as
// here, took 0.0589.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_bits.cuh"

namespace {

constexpr int kWarps = 16;   // warps per CTA
constexpr int kWin = 256;    // words of a warp's window (>= cap_words + 1)
constexpr unsigned kAll = 0xffffffffu;

// Write the four bytes of `v` (MSB first) at `p`, each 0xFF followed by a
// stuffed 0x00.
__device__ __forceinline__ void put_word(uint8_t* p, uint32_t v) {
#pragma unroll
  for (int k = 24; k >= 0; k -= 8) {
    const uint32_t byte = (v >> k) & 0xFFu;
    *p++ = (uint8_t)byte;
    if (byte == 0xFFu) *p++ = 0;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
merge_stuff_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ bits, int cap_words,
                   const int32_t* __restrict__ seg_start,
                   const int32_t* __restrict__ seg_count,
                   const int32_t* __restrict__ rst,
                   const int32_t* __restrict__ has_rst,
                   int n_seg, int cap_out,
                   uint8_t* __restrict__ out,
                   int32_t* __restrict__ out_len,
                   int32_t* __restrict__ seg_bits,
                   int32_t* __restrict__ n_ff) {
  __shared__ uint32_t s_win[kWarps][kWin];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= n_seg) return;
  uint32_t* win = s_win[warp];
  for (int i = lane; i < kWin; i += 32) win[i] = 0u;
  __syncwarp();
  const int cap_bits = 32 * cap_words;
  const int end = seg_start[s] + seg_count[s];
  uint8_t* o = out + (size_t)s * cap_out;
  int pos = 0, nff = 0, total = 0;
  uint32_t cw = 0u;  // carry: the first `carry` bits of the next word
  int carry = 0;
  for (int b0 = seg_start[s]; b0 < end;) {
    const int b = b0 + lane;
    const int len = b < end ? min(bits[b], cap_bits) : 0;
    const int incl = warp_inclusive_scan(len, lane);
    const bool fits = b < end && carry + incl <= 32 * kWin;
    const int n_take = __popc(__ballot_sync(kAll, fits));
    const int step_bits = __shfl_sync(kAll, incl, n_take - 1);
    if (fits) {
      const uint32_t* w = words + (size_t)b * cap_words;
      int off = carry + incl - len;
      for (int i = 0, left = len; left > 0; ++i, left -= 32, off += 32) {
        const int t = min(left, 32);
        or_field_row(win, kWin, off, w[i] >> (32 - t), t);
      }
    }
    __syncwarp();
    const int fill = carry + step_bits;
    const int n_full = fill >> 5;
    for (int g = 0; g < n_full; g += 32) {
      const int i = g + lane;
      const uint32_t v = i < n_full ? win[i] | (i == 0 ? cw : 0u) : 0u;
      const int n_out = i < n_full ? 4 + __popc(__vcmpeq4(v, kAll)) / 8 : 0;
      const int incl_o = warp_inclusive_scan(n_out, lane);
      if (i < n_full) put_word(o + pos + incl_o - n_out, v);
      const int group = __shfl_sync(kAll, incl_o, 31);
      pos += group;
      nff += group - 4 * min(32, n_full - g);
    }
    const uint32_t next =
        (fill & 31) ? win[n_full] | (n_full == 0 ? cw : 0u) : 0u;
    __syncwarp();
    for (int i = lane; i < (fill + 31) >> 5; i += 32) win[i] = 0u;
    __syncwarp();
    cw = next;
    carry = fill & 31;
    total += step_bits;
    b0 += n_take;
  }
  if (lane == 0) {
    const int pad = (8 - (carry & 7)) & 7;
    const uint32_t v =
        pad ? cw | (((1u << pad) - 1u) << (32 - carry - pad)) : cw;
    for (int k = 0; k < (carry + pad) >> 3; ++k) {
      const uint32_t byte = (v >> (24 - 8 * k)) & 0xFFu;
      o[pos++] = (uint8_t)byte;
      if (byte == 0xFFu) {
        o[pos++] = 0;
        ++nff;
      }
    }
    if (has_rst[s]) {
      o[pos++] = 0xFF;
      o[pos++] = (uint8_t)rst[s];
    }
    out_len[s] = pos;
    seg_bits[s] = total;
    n_ff[s] = nff;
  }
}

}  // namespace

extern "C" int gj_merge_stuff(const void* words, const void* bits,
                              int cap_words, const void* seg_start,
                              const void* seg_count, const void* rst,
                              const void* has_rst, int n_seg, int cap_out,
                              void* out, void* out_len, void* seg_bits,
                              void* n_ff, void* stream) {
  if (cap_words < 1 || cap_words >= kWin) return (int)cudaErrorInvalidValue;
  if (n_seg <= 0) return (int)cudaGetLastError();
  const int ctas = (n_seg + kWarps - 1) / kWarps;
  merge_stuff_kernel<<<(unsigned)ctas, kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)bits, cap_words,
      (const int32_t*)seg_start, (const int32_t*)seg_count,
      (const int32_t*)rst, (const int32_t*)has_rst, n_seg, cap_out,
      (uint8_t*)out, (int32_t*)out_len, (int32_t*)seg_bits,
      (int32_t*)n_ff);
  return (int)cudaGetLastError();
}
