// D0 destuff_rows: the restart segments of the scan bytes on the card ->
// D1's rows of destuffed big-endian u32 words.
//
// Replaces no TPU kernel: the JAX reference and the port before it built
// the rows on the host (the native `gj_build_rows`,
// native/host_codec.cpp) and uploaded them, 1.77x the scan's bytes at 8K
// since every row is padded to the longest segment. This kernel takes over
// `gj_build_rows` on the decode's card route (`ops/decode.py`
// `destuff_rows`): the host uploads the scans' bytes and each segment's
// (lo, hi), and D1's input is built where D1 reads it.
//
// Input: the scans' bytes laid end to end (n bytes); per segment its
// [lo, hi) in them as int32, lo = -1 for a missing segment (ranges holds
// lo[S] then hi[S]). Output: rows (S, wcap) int32, row s the bytes of
// segment s with every 0x00 dropped whose predecessor *in the segment* is
// 0xFF (a segment's first byte is never dropped; FF 00 00 keeps the second
// 00, FF FF 00 both FFs), packed big-endian four to a word; every word past
// the data is zero, a row whose segment is missing (lo < 0, hi <= lo or
// hi > n) is zero, and data past 4 * wcap bytes is cut, as `gj_build_rows`
// does. Every word of every row is written, so the rows need no memset.
//
// What bounds it: bytes, the scans read once and the rows written once
// (4.3 MB + 7.6 MB at 8K: 3.6 us at 3.35 TB/s); with 48,600 segments of
// ~88 bytes at 8K each warp does one or two steps, so latency sets the
// time. The design: a warp a segment. A step reads 128 bytes, four
// consecutive ones a lane (the warp's reads one contiguous run); a byte's
// predecessor is the lane's own or lane - 1's last (a shuffle), and lane 0's
// is the last byte of the step before, carried across. Each lane counts
// its kept bytes, an exclusive warp scan of the counts gives each kept
// byte its place, and it goes into a ring of 256 bytes in shared memory:
// before a step the ring holds under 128 bytes, so it never holds 256.
// When the ring holds 128 bytes or more, the warp stores 32 words at once,
// lane i word i (coalesced, bytes swapped into big-endian order). The
// tail stores the ring's last bytes, zero-padded, and zero words to wcap.
// Segments of any length take as many steps as they need.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // segments a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 128;               // raw bytes a warp reads a step
constexpr int kRing = 2 * kStep;         // destuffed bytes a warp stages
constexpr unsigned kFull = 0xffffffffu;

// The big-endian word of ring bytes i .. i + 3, those at `end` or past it
// zero.
__device__ __forceinline__ uint32_t ring_word(const uint8_t* ring, int i,
                                              int end) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < end)
      w |= (uint32_t)ring[(i + j) & (kRing - 1)] << (24 - 8 * j);
  return w;
}

__global__ void __launch_bounds__(kThreads)
destuff_rows_kernel(const uint8_t* __restrict__ data, long long n,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi, int n_seg, int wcap,
                    uint32_t* __restrict__ rows) {
  __shared__ uint8_t rings[kWarps][kRing];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= n_seg) return;  // the whole warp
  uint8_t* ring = rings[warp];
  uint32_t* row = rows + (size_t)s * wcap;
  int a = lo[s], b = hi[s];
  if (a < 0 || b <= a || b > n) a = b = 0;  // a missing segment: zeros
  int out = 0;         // destuffed bytes so far
  int stored = 0;      // words of the row stored
  uint32_t carry = 0;  // the byte before the step (none: not 0xFF)
  for (int c = a; c < b; c += kStep) {
    const int p = c + 4 * lane;
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = p + j < b ? __ldg(data + p + j) : 0u;
    const uint32_t up = __shfl_up_sync(kFull, x[3], 1);
    uint32_t prev = lane == 0 ? carry : up;
    bool keep[4];
    int k = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keep[j] = p + j < b && !(x[j] == 0 && prev == 0xFF);
      k += keep[j];
      prev = x[j];
    }
    int incl = k;  // inclusive scan of the kept counts over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    int at = out + incl - k;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keep[j]) ring[(at++) & (kRing - 1)] = (uint8_t)x[j];
    out += __shfl_sync(kFull, incl, 31);
    carry = __shfl_sync(kFull, x[3], 31);  // a further step: a full one
    __syncwarp();
    if (out - 4 * stored >= kStep) {
      const int w = stored + lane;
      if (w < wcap) row[w] = ring_word(ring, 4 * w, out);
      stored += 32;
      __syncwarp();
    }
  }
  for (int w = stored + lane; w < wcap; w += 32)
    row[w] = ring_word(ring, 4 * w, out);
}

}  // namespace

extern "C" int gj_destuff_rows(const void* data, long long n,
                               const void* ranges, int n_seg, int wcap,
                               void* rows, void* stream) {
  if (n_seg < 0 || wcap < 1 || n < 0 || n > 0x7fffffffLL - kStep)
    return (int)cudaErrorInvalidValue;
  const int ctas = (n_seg + kWarps - 1) / kWarps;
  if (ctas > 0) {
    const int32_t* r = (const int32_t*)ranges;
    destuff_rows_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, r, r + n_seg, n_seg, wcap,
        (uint32_t*)rows);
  }
  return (int)cudaGetLastError();
}
