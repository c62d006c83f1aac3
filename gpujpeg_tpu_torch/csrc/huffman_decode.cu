// D1 huffman_decode: segment-parallel Huffman decode of destuffed rows into
// zig-zag coefficients.
//
// Replaces the Huffman half of `pallas_decode_v3.make_decode_kernel_v3`
// (K2, gpujpeg_tpu/ops/pallas_decode_v3.py:100, body :157-504), and computes
// for in-slice plans what its coefficient form `run_raw` (K4) emits.
//
// Input: rows (S, wcap) of big-endian u32 words, segment s's destuffed
// entropy bytes from word 0 (words past the data are zero); per segment its
// first block and block count; per block its component; the reference's
// decode tables (`build_dec_tables_v2`: 8-bit quick table, T.81 F.16
// maxcode/delta/huffval) for up to 4 slots and the component -> slot maps.
// Output: (NB, 64) int32 coefficients in scan order. The caller zeroes the
// output; the kernel writes the DC and every non-zero AC coefficient.
//
// One thread per restart segment, as GPUJPEG's decoder: the thread keeps a
// 64-bit bit accumulator, refilled one row word at a time, and decodes its
// blocks in order with per-component DC prediction reset at the segment
// start. Symbol lookup is K2's `lookup_sym`: the quick table first, else
// s_len = 9 + #(peek16 >= maxcode[l]) over l = 9..16 and
// huffval[clip(code + delta[s_len], 0, 255)]; s_len == 17 is an invalid code
// (symbol 0, one bit). Corrupt-stream guards are K2's: reads past wcap see
// zero words, and a position k + run > 63 writes nothing and ends the block
// after consuming the symbol's value bits.
//
// What bounds it: latency. Each symbol is a chain of dependent shared-memory
// table lookups and shifts, and symbol counts differ between the segments of
// a warp. At 8K there are 48,600 segments, about 12 warps per SM, too few to
// hide that latency well. The design keeps every table in shared memory
// (8.8 KB) and the bits in registers; it reads each row word once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 4;
constexpr int kQuickBits = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ int shl1(int n) {  // 1 << n, 0 for n >= 32
  return n >= 32 ? 0 : (int)(1u << n);
}

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint32_t* __restrict__ rows, int wcap,
                      const int32_t* __restrict__ seg_start,
                      const int32_t* __restrict__ seg_count, int n_seg,
                      const int32_t* __restrict__ block_comp,
                      const int32_t* __restrict__ quick,    // (n_slots, 256)
                      const int32_t* __restrict__ maxcode,  // (n_slots, 18)
                      const int32_t* __restrict__ delta,    // (n_slots, 17)
                      const int32_t* __restrict__ huffval,  // (n_slots, 256)
                      const int32_t* __restrict__ dc_slot,  // (4,)
                      const int32_t* __restrict__ ac_slot,  // (4,)
                      int n_slots, int32_t* __restrict__ out) {
  __shared__ int s_quick[kMaxSlots << kQuickBits];
  __shared__ int s_huffval[kMaxSlots * 256];
  __shared__ int s_maxcode[kMaxSlots * 18];
  __shared__ int s_delta[kMaxSlots * 17];
  __shared__ int s_dc[4], s_ac[4];
  for (int i = threadIdx.x; i < (n_slots << kQuickBits); i += blockDim.x)
    s_quick[i] = quick[i];
  for (int i = threadIdx.x; i < n_slots * 256; i += blockDim.x)
    s_huffval[i] = huffval[i];
  for (int i = threadIdx.x; i < n_slots * 18; i += blockDim.x)
    s_maxcode[i] = maxcode[i];
  for (int i = threadIdx.x; i < n_slots * 17; i += blockDim.x)
    s_delta[i] = delta[i];
  if (threadIdx.x < 4) {
    s_dc[threadIdx.x] = dc_slot[threadIdx.x];
    s_ac[threadIdx.x] = ac_slot[threadIdx.x];
  }
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;
  const uint32_t* row = rows + (size_t)s * wcap;
  uint64_t acc = 0;  // the next `nb` bits of the segment, MSB first
  int nb = 0;
  int wp = 0;        // next row word to load

  auto refill = [&]() {
    while (nb <= 32) {
      const uint32_t w = wp < wcap ? row[wp] : 0u;
      ++wp;
      acc |= (uint64_t)w << (32 - nb);
      nb += 32;
    }
  };
  auto skip = [&](int n) {
    while (n > 0) {
      refill();
      const int t = n < 32 ? n : 32;
      acc <<= t;
      nb -= t;
      n -= t;
    }
  };

  int dc[4] = {0, 0, 0, 0};
  const int first = seg_start[s], end = first + seg_count[s];
  for (int b = first; b < end; ++b) {
    const int comp = block_comp[b];
    const int ds = s_dc[comp], as = s_ac[comp];
    int32_t* o = out + (size_t)b * 64;
    int k = 0;
    while (k < 64) {
      refill();
      const uint32_t view = (uint32_t)(acc >> 32);
      const int peek16 = (int)(view >> 16);
      const bool is_dc = k == 0;
      const int slot = is_dc ? ds : as;
      int sym, ln;
      const int q = s_quick[(slot << kQuickBits) + (peek16 >> (16 - kQuickBits))];
      if (q & 31) {
        sym = q >> 5;
        ln = q & 31;
      } else {
        int len = kQuickBits + 1;
#pragma unroll
        for (int l = kQuickBits + 1; l <= 16; ++l)
          len += peek16 >= s_maxcode[slot * 18 + l];
        if (len == 17) {  // invalid code: symbol 0, one bit
          sym = 0;
          ln = 1;
        } else {
          int v = (peek16 >> (16 - len)) + s_delta[slot * 17 + len];
          v = min(max(v, 0), 255);
          sym = s_huffval[slot * 256 + v];
          ln = len;
        }
      }
      const int cat = is_dc ? sym : (sym & 15);
      const int run = is_dc ? 0 : (sym >> 4);
      int val = 0;
      if (cat > 0) {
        const int sh = min(cat, 16);
        const int vraw = (int)((view << ln) >> (32 - sh));
        val = vraw < shl1(cat - 1)
                  ? (int)((uint32_t)vraw - (uint32_t)shl1(cat) + 1u)
                  : vraw;
      }
      skip(ln + cat);
      if (is_dc) {
        dc[comp] = (int)((uint32_t)dc[comp] + (uint32_t)val);
        o[0] = dc[comp];
        k = 1;
      } else if (cat == 0) {
        k = run == 15 ? k + 16 : 64;  // ZRL or EOB
      } else {
        const int pos = k + run;
        if (pos <= 63) o[pos] = val;
        k = pos + 1;
      }
    }
  }
}

}  // namespace

extern "C" int gj_huffman_decode(const void* rows, int wcap,
                                 const void* seg_start, const void* seg_count,
                                 int n_seg, const void* block_comp,
                                 const void* quick, const void* maxcode,
                                 const void* delta, const void* huffval,
                                 const void* dc_slot, const void* ac_slot,
                                 int n_slots, void* out, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  const int ctas = (n_seg + kThreads - 1) / kThreads;
  if (ctas > 0)
    huffman_decode_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, wcap, (const int32_t*)seg_start,
        (const int32_t*)seg_count, n_seg, (const int32_t*)block_comp,
        (const int32_t*)quick, (const int32_t*)maxcode,
        (const int32_t*)delta, (const int32_t*)huffval,
        (const int32_t*)dc_slot, (const int32_t*)ac_slot, n_slots,
        (int32_t*)out);
  return (int)cudaGetLastError();
}
