// D1 huffman_decode: segment-parallel Huffman decode of destuffed rows into
// zig-zag coefficients.
//
// Replaces the Huffman half of `pallas_decode_v3.make_decode_kernel_v3`
// (K2, gpujpeg_tpu/ops/pallas_decode_v3.py:100, body :157-504), and computes
// for in-slice plans what its coefficient form `run_raw` (K4) and the v2
// decoder (K5) emit.
//
// Input: rows (S, wcap) of big-endian u32 words, segment s's destuffed
// entropy bytes from word 0 (words past the data are zero), 16-byte
// aligned; per segment its first block and block count (the segments cover
// every block once: `decode.check_cover`, run where the decode context
// builds them); per block its component; the
// first-level table `wide` (`decode.wide_quick_tables`, kWideBits bits) and
// the reference's T.81 F.16 maxcode/delta/huffval (`build_dec_tables_v2`)
// for up to 4 slots; the component -> slot maps. Output: (NB, 64) int32
// coefficients in scan order, every block written whole.
//
// One thread per restart segment, as GPUJPEG's decoder and the reference's
// unit of parallelism: the thread keeps a 64-bit bit accumulator and decodes
// its blocks in order with per-component DC prediction reset at the segment
// start. Symbol lookup is K2's `lookup_sym` (huffman_sym.cuh): a hit in
// `wide` (whose entries are the reference lookup's by construction), else
// s_len = 9 + #(peek16 >= maxcode[l]) over l = 9..16 and
// huffval[clip(code + delta[s_len], 0, 255)]; s_len == 17 is an invalid code
// (symbol 0, one bit). Corrupt-stream guards
// are K2's: reads past wcap see zero words, and a position k + run > 63
// writes nothing and ends the block after consuming the symbol's value bits.
//
// What bounds it: latency. Each symbol is a chain of dependent shared-memory
// lookups and shifts, symbol counts differ between the segments of a warp,
// and at 8K there are 48,600 segments, about 12 warps per SM. The design
// keeps the chain short and off global memory:
//   * refills come from registers: a thread holds the current 16-byte chunk
//     of its row and the next one, loaded (through the read-only path) when
//     the current one is taken, so a load has a whole chunk's symbols to
//     land. Chunks are aligned to 16 bytes in memory, whatever wcap is: a
//     row's first chunk may start in the row before (those words are
//     skipped), its last one end in the next (masked by wcap);
//   * the first-level table has kWideBits = 11 bits (most codes and every
//     code of 11 bits or fewer hit it), as 16-bit entries in shared memory;
//     longer codes take the reference's eight maxcode compares;
//   * no memset: each lane decodes block i of its segment into its own
//     zeroed row of 64 ints in shared memory; then the warp writes the 32
//     lanes' blocks (256 contiguous bytes each) with 16-byte stores and
//     zeroes the rows as it reads them. Lanes whose segment has fewer blocks
//     sit out. The next block's component is loaded a block ahead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_sym.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRow4 = 17;  // int4s of a lane's row: 64 ints + 4 spread banks
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  int4 blk[kWarps][32 * kRow4];
  uint16_t wide[kMaxSlots << kWideBits];
  int huffval[kMaxSlots * 256];
  int maxcode[kMaxSlots * 18];
  int delta[kMaxSlots * 17];
  int dc[4], ac[4];
};

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint32_t* __restrict__ rows, int wcap,
                      const int32_t* __restrict__ seg_start,
                      const int32_t* __restrict__ seg_count, int n_seg,
                      const int32_t* __restrict__ block_comp,
                      const int32_t* __restrict__ wide,     // (n_slots, 2048)
                      const int32_t* __restrict__ maxcode,  // (n_slots, 18)
                      const int32_t* __restrict__ delta,    // (n_slots, 17)
                      const int32_t* __restrict__ huffval,  // (n_slots, 256)
                      const int32_t* __restrict__ dc_slot,  // (4,)
                      const int32_t* __restrict__ ac_slot,  // (4,)
                      int n_slots, int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  for (int i = threadIdx.x; i < (n_slots << kWideBits); i += kThreads)
    sm.wide[i] = (uint16_t)wide[i];
  for (int i = threadIdx.x; i < n_slots * 256; i += kThreads)
    sm.huffval[i] = huffval[i];
  for (int i = threadIdx.x; i < n_slots * 18; i += kThreads)
    sm.maxcode[i] = maxcode[i];
  for (int i = threadIdx.x; i < n_slots * 17; i += kThreads)
    sm.delta[i] = delta[i];
  if (threadIdx.x < 4) {
    sm.dc[threadIdx.x] = dc_slot[threadIdx.x];
    sm.ac[threadIdx.x] = ac_slot[threadIdx.x];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* rowbuf = sm.blk[warp];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    rowbuf[(2 * j + (lane >> 4)) * kRow4 + (lane & 15)] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool live = s < n_seg;
  const int first = live ? seg_start[s] : 0;
  const int count = live ? seg_count[s] : 0;
  const int max_count = __reduce_max_sync(kFull, count);
  if (max_count <= 0) return;

  // the bit reader: `acc` holds the next `nb` bits MSB first; `cur` the
  // rest of the current chunk (`ncur` words), `nxt` the next chunk; `wp`
  // the row index of the next word handed out
  const long long total = (long long)n_seg * wcap;
  const long long row0 = (long long)(live ? s : 0) * wcap;
  const long long row_end = count > 0 ? row0 + wcap : row0;  // idle: no loads
  long long ch = row0 >> 2;
  uint4 cur = load_chunk(rows, ch++, row_end, total);
  uint4 nxt = load_chunk(rows, ch++, row_end, total);
  int ncur = 4;
  for (int i = 0; i < (int)(row0 & 3); ++i) {
    cur.x = cur.y; cur.y = cur.z; cur.z = cur.w;
    --ncur;
  }
  int wp = 0;
  uint64_t acc = 0;
  int nb = 0;

  auto refill = [&]() {
    while (nb <= 32) {
      if (ncur == 0) {
        cur = nxt;
        ncur = 4;
        nxt = load_chunk(rows, ch++, row_end, total);
      }
      const uint32_t w = wp < wcap ? cur.x : 0u;
      cur.x = cur.y; cur.y = cur.z; cur.z = cur.w;
      --ncur;
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

  int* o = reinterpret_cast<int*>(rowbuf + lane * kRow4);
  int dc0 = 0, dc1 = 0, dc2 = 0, dc3 = 0;
  int comp_next = count > 0 ? __ldg(block_comp + first) : 0;
  for (int i = 0; i < max_count; ++i) {
    if (i < count) {
      const int comp = comp_next;
      if (i + 1 < count) comp_next = __ldg(block_comp + first + i + 1);
      const int ds = sm.dc[comp], as = sm.ac[comp];
      int k = 0;
      while (k < 64) {
        refill();
        const uint32_t view = (uint32_t)(acc >> 32);
        const bool is_dc = k == 0;
        const int slot = is_dc ? ds : as;
        int sym, ln;
        lookup_sym(sm.wide, sm.maxcode, sm.delta, sm.huffval, slot, view, sym,
                   ln);
        const int cat = is_dc ? sym : (sym & 15);
        const int run = is_dc ? 0 : (sym >> 4);
        const int val = extend_value(view, ln, cat);
        skip(ln + cat);
        if (is_dc) {
          const int pred =
              comp == 0 ? dc0 : comp == 1 ? dc1 : comp == 2 ? dc2 : dc3;
          const int now = (int)((uint32_t)pred + (uint32_t)val);
          dc0 = comp == 0 ? now : dc0;
          dc1 = comp == 1 ? now : dc1;
          dc2 = comp == 2 ? now : dc2;
          dc3 = comp == 3 ? now : dc3;
          o[0] = now;
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
    __syncwarp();
    // the warp's blocks i, two at a time: lanes 16 h .. 16 h + 15 move the
    // 16 int4s of lane 2 j + h's row to its block and zero them
    const unsigned act = __ballot_sync(kFull, i < count);
    const int mine = first + i;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int L = 2 * j + (lane >> 4), e = lane & 15;
      const int blk = __shfl_sync(kFull, mine, L);
      if ((act >> L) & 1u) {
        int4* p = rowbuf + L * kRow4 + e;
        const int4 v = *p;
        *p = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(out)[(size_t)blk * 16 + e] = v;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int gj_huffman_decode(const void* rows, int wcap,
                                 const void* seg_start, const void* seg_count,
                                 int n_seg, const void* block_comp,
                                 const void* wide, const void* maxcode,
                                 const void* delta, const void* huffval,
                                 const void* dc_slot, const void* ac_slot,
                                 int n_slots, void* out, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)rows % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      huffman_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int ctas = (n_seg + kThreads - 1) / kThreads;
  if (ctas > 0)
    huffman_decode_kernel<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, wcap, (const int32_t*)seg_start,
        (const int32_t*)seg_count, n_seg, (const int32_t*)block_comp,
        (const int32_t*)wide, (const int32_t*)maxcode,
        (const int32_t*)delta, (const int32_t*)huffval,
        (const int32_t*)dc_slot, (const int32_t*)ac_slot, n_slots,
        (int32_t*)out);
  return (int)cudaGetLastError();
}
