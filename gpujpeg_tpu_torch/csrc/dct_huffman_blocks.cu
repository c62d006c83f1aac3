// E12 dct_huffman_blocks: f32 zig-zag DCT + quantisation fused with the
// per-block Huffman bit strings, so that the coefficients never reach
// device memory.
//
// Replaces `entropy_v2.block_chunks_dct_pallas` (K12) of the JAX reference
// (u8 pixel pairs -> MXU DCT -> `_chunk_planes_packed` windows) and, by the
// STOP template argument, the ablation kernel of
// `scripts/ablate_stage1.py` (`build` -> `kernel`, body `kernel_body`),
// which is K12 cut after one stage.
//
// Input: blocks (NB, 64) u8 in row-major pixel order; per block the DC
// difference `diff`, class `cls` (0 luma / 1 chroma), `valid` and the
// divisor row `qsel`; divisors qdiv (n_q, 64) f32; the level-shift bias
// (64,) of the zig-zag DCT operator; the packed Annex-K tables ac512 and
// dc64 (`code << 5 | len`). Output: words (NB, cap_words) and bits (NB,).
// The kernel reads no operator: it computes `tables.dct_zigzag_operator()`'s
// product in separable form (dct8.cuh's compiled-in factor), and the
// wrapper refuses any other operator.
//
// STOP = kFull (E12). q = rint((x @ dct - bias) / qdiv[qsel]) with E1's
// and E1p's numerics exactly: dct8.cuh's `fdct8_row` and `fdct8_col` on
// the raw pixels, the bias subtracted with one rounded `__fsub_rn`, IEEE
// `__fdiv_rn` by the block's own divisor row, `rintf` half-to-even; so
// E12's quotients equal E1p's (fdct_quant_planes.cu) bit for bit on the
// same blocks and divisors. Then E2's walk (block_walk.cuh) with three differences: the
// DC symbol codes `diff`, a block with valid == 0 writes no string and has
// bits 0, and the string is cut at cap_words words (the DC table index is
// min(cat, 15) in both). An EOB follows when q[63] == 0. bits is the full
// length (cap_words = W is K12's contract, truncation included;
// cap_words = 56 is E2's layout, which E3 takes). Words past
// ceil(min(bits, 32 cap_words) / 32) are unspecified (zero where
// cap_words <= kStage). Strings of more than 56 words (only `lookups`'
// uncut fields reach them) keep their first 56.
//
// The other modes write what the script's mode of the same name writes,
// in K12's pair rows: block 2i is the left half of pair row i, 2i+1 the
// right. The script's modes write 8 words and 2 bits per pair row, which
// is this layout at cap_words = 4 (its W at Q75); so, with e = b & ~1 the
// pair's left block and h = b & 1, word w of block b is V_e[h cap_words +
// w] (0 where that index is 8 or more) and bits[b] is B_e[h], where:
//   kPassthru  V = B = the pixels x (no DCT);
//   kDctOnly   V = B = (int)y, truncated, y = x @ dct - bias (no divisor);
//   kDct       V = B = q, the quotients;
//   kDctMul    V = B = rint(y * qdiv[qsel]): a multiply in place of the
//              division (by the divisor itself, as in the script: it times
//              the division, and its values are not quotients);
//   kSynth     v = (diff, q[1..63]): V = cat(v) + its value bits, B =
//              cat(v) (stops after symbol synthesis);
// and further
//   kIo        no DCT: every word of block b is pixel 0 of the first block
//              of its group of 64 blocks (the script's io at a tile of 64
//              blocks: it writes the tile's first pixel), bits[b] that
//              block's diff;
//   kLookups   the kFull walk with the DC and AC symbols' entries from
//              arithmetic, entry = sym * 3 + cls (sym = cat for the DC, run
//              << 4 | cat for an AC symbol; ZRL and EOB from the tables),
//              and each field (code << cat | value bits, len + cat bits,
//              neither cut to its length) placed by K12's window formula
//              (block_walk.cuh's kArith placement); a block with valid == 0
//              as in kFull.
// Only kLookups and kFull read `valid`. y and q are the separable ones, so
// every mode's values are E1p's.
//
// Design: a CTA of 256 threads walks strips of kTB = 32 consecutive
// blocks (a grid stride, at most 6 CTAs an SM of the H100's 132:
// `dct_huffman_grid` in ops/entropy.py). The Huffman tables sit in
// shared memory, staged once per CTA; each walking lane keeps the bias
// and the tile offsets of its two zig-zag positions in registers and
// reads its divisors through the L1 cache. Per strip:
//   * front end: thread (b, r) = (t / 8, t % 8) holds row r of block b,
//     one 8-byte load (bytes where `blocks` is not 8-byte aligned), so a
//     warp loads 256 contiguous bytes and the CTA the strip's 2 KB span;
//     warp 0 holds the strip's diff, cls, valid and qsel. The next
//     strip's rows and side data are in flight in registers while this
//     strip is worked;
//   * E1's passes: thread (b, r) runs the row pass of its row into a tile
//     per block, then thread (b, u) the column pass of column u in place;
//     rows are 9 floats apart and blocks 72, so both passes' 32 lanes hit
//     32 banks (io and passthru store the pixels instead);
//   * the walk: warp w takes blocks w, w + 8, w + 16, w + 24. Lane l reads
//     the DCT values of its zig-zag positions 2l and 2l+1 from the tile,
//     subtracts their bias and divides them by the block's divisors (the
//     quotients stay in registers), and block_walk.cuh makes the string:
//     runs from two ballots, offsets from a warp scan, a string of at
//     most 64 bits built in registers, a longer one in a zeroed shared
//     row. Fields wholly past bit 32 cap_words are counted, not placed.
//     The pair-row modes compute every block's values the same way (and
//     synth its categories), the right block of a pair kept alive with an
//     empty asm, so that each mode is a cut of kFull; the warp of the
//     pair's left block writes both blocks' words;
//   * stores: for cap_words <= kStage the strings are ORed into a zeroed
//     row per block of a strip buffer in shared memory, which the CTA
//     writes as one run of 32 cap_words words with coalesced stores; for
//     larger caps the warp stores a block's first ceil(bits / 32) words
//     (lanes 0..) from its registers or its 56-word shared row, as E2
//     does. bits go out as one coalesced run a strip.
// Alternatives timed against this design at 8K and slower (PERF.md,
// section 6): quotients held as int32 in a zig-zag tile in shared memory,
// written by the column pass (each thread dividing its column's 8
// values); the divisors staged in shared memory in place of L1 reads; a
// warp that runs the passes and the walk of its own 4 blocks (no CTA
// barrier, but spills at 40 registers); strings of up to 128 bits joined
// in registers by four __reduce_or_sync, or every string placed by
// shared atomics (the register join wins at up to 64 bits, the atomics
// above).
//
// What bounds it: the separable DCT's 2,176 operations a block (0.051 ms
// at 8K, 1,555,200 blocks, at 67 TFLOP/s) over the bytes (~155 MB at
// W = 4, 0.046 ms); in practice the issue of the walk's fixed warp
// sequence (ballots, scan, placement), of the two IEEE divisions a lane
// and of the strip's three barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_walk.cuh"
#include "dct8.cuh"

namespace {

constexpr int kTB = 32;               // blocks per strip
constexpr int kThreads = kTB * 8;     // thread (b, r): block b, row/column r
constexpr int kWarps = kThreads / 32;
constexpr int kRowPitch = 9;          // floats per tile row
constexpr int kTile = 8 * kRowPitch;  // floats per block tile
constexpr int kRow = 56;              // words of a warp's row (BLOCK_CAP_WORDS)
constexpr int kStage = 8;             // caps staged a strip in shared memory
constexpr int kIoGroup = 64;          // io: blocks per group
constexpr int kPairVals = 8;          // values the script writes per pair row
constexpr int kCtasPerSm = 6;         // 40 registers a thread
constexpr int kMaxCtas = 132 * kCtasPerSm;  // ops/entropy.py E12_MAX_CTAS

enum Stop {
  kIo = 0, kPassthru, kDctOnly, kDct, kDctMul, kSynth, kLookups, kFull
};

__device__ __forceinline__ uint2 load_row(const uint8_t* __restrict__ q,
                                          int vec) {
  if (vec) return *reinterpret_cast<const uint2*>(q);
  return make_uint2(
      q[0] | (q[1] << 8) | (q[2] << 16) | ((uint32_t)q[3] << 24),
      q[4] | (q[5] << 8) | (q[6] << 16) | ((uint32_t)q[7] << 24));
}

// Keep `v` computed although no output reads it (the pair-row modes'
// right blocks).
__device__ __forceinline__ void keep(int2 v) {
  asm volatile("" ::"r"(v.x), "r"(v.y));
}

template <int STOP>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
dct_huffman_blocks_kernel(const uint8_t* __restrict__ blocks, int vec,
                          int NB, const int32_t* __restrict__ diff,
                          const int32_t* __restrict__ cls,
                          const int32_t* __restrict__ valid,
                          const int32_t* __restrict__ qsel,
                          const float* __restrict__ qdiv,  // (n_q, 64)
                          const float* __restrict__ bias,  // (64,)
                          const int32_t* __restrict__ ac512,
                          const int32_t* __restrict__ dc64, int cap_words,
                          uint32_t* __restrict__ words,
                          int32_t* __restrict__ bits) {
  constexpr bool kDoDct = STOP != kIo && STOP != kPassthru;
  constexpr bool kWalk = STOP == kLookups || STOP == kFull;
  __shared__ float tile[kTB * kTile];
  __shared__ int s_ac[512];
  __shared__ int s_dc[64];
  __shared__ uint32_t s_out[kTB * kStage];
  __shared__ uint32_t s_row[kWarps][kRow];
  __shared__ int s_diff[kTB], s_cls[kTB], s_valid[kTB], s_sel[kTB];
  __shared__ int32_t s_bits[kTB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = tid >> 3, r = tid & 7;  // thread (b, r) of the passes
  for (int i = tid; i < 512; i += kThreads) s_ac[i] = ac512[i];
  if (tid < 64) s_dc[tid] = dc64[tid];
  for (int i = tid; i < kTB * kStage; i += kThreads) s_out[i] = 0u;
  for (int i = tid; i < kWarps * kRow; i += kThreads)
    s_row[i / kRow][i % kRow] = 0u;
  // the walking lane's values 2l and 2l+1: tile offsets of their zig-zag
  // positions (DCT modes) or raster positions (passthru), and biases
  const int z0 = 2 * lane, z1 = 2 * lane + 1;
  const int n0 = kDoDct ? kZigzagToNatural[z0] : z0;
  const int n1 = kDoDct ? kZigzagToNatural[z1] : z1;
  const int at0 = (n0 >> 3) * kRowPitch + (n0 & 7);
  const int at1 = (n1 >> 3) * kRowPitch + (n1 & 7);
  const float bz0 = bias[z0], bz1 = bias[z1];
  const bool staged = cap_words <= kStage;
  // (the loop's first barrier orders the staging before any use)

  const long long n_strips = ((long long)NB + kTB - 1) / kTB;
  auto strip_n = [&](long long s) {
    return (int)min((long long)kTB, (long long)NB - s * kTB);
  };
  auto load_px = [&](long long s) {
    return b < strip_n(s)
               ? load_row(blocks + (s * kTB + b) * 64 + r * 8, vec)
               : make_uint2(0u, 0u);
  };
  auto load_meta = [&](long long s) {
    const long long i = s * kTB + tid;
    return tid < strip_n(s)
               ? make_int4(diff[i], cls[i], valid[i], qsel[i])
               : make_int4(0, 0, 0, 0);
  };
  // block bb's values 2l and 2l+1 in the mode's form (lanes of one warp)
  auto values = [&](int bb) -> int2 {
    const float* t = &tile[bb * kTile];
    if (STOP == kPassthru) return make_int2((int)t[at0], (int)t[at1]);
    const float y0 = __fsub_rn(t[at0], bz0), y1 = __fsub_rn(t[at1], bz1);
    if (STOP == kDctOnly) return make_int2((int)y0, (int)y1);
    const float* qrow = qdiv + s_sel[bb] * 64;
    const float q0 = __ldg(qrow + z0), q1 = __ldg(qrow + z1);
    if (STOP == kDctMul)
      return make_int2((int)rintf(__fmul_rn(y0, q0)),
                       (int)rintf(__fmul_rn(y1, q1)));
    return make_int2((int)rintf(__fdiv_rn(y0, q0)),
                     (int)rintf(__fdiv_rn(y1, q1)));
  };
  // io: pixel 0 and diff of the first block of strip s's group of
  // kIoGroup blocks
  auto load_io = [&](long long s) {
    if (STOP != kIo) return make_uint2(0u, 0u);
    const long long g = (s * kTB) & ~(long long)(kIoGroup - 1);
    return make_uint2(blocks[g * 64], (uint32_t)diff[g]);
  };
  uint2 px_next = make_uint2(0u, 0u), io_next = make_uint2(0u, 0u);
  int4 meta_next = make_int4(0, 0, 0, 0);
  if (blockIdx.x < n_strips) {
    px_next = load_px(blockIdx.x);
    meta_next = load_meta(blockIdx.x);
    io_next = load_io(blockIdx.x);
  }

  for (long long s = blockIdx.x; s < n_strips; s += gridDim.x) {
    const int n = strip_n(s);
    const long long first = s * kTB;
    const uint2 px = px_next, io = io_next;
    const int4 meta = meta_next;
    if (s + gridDim.x < n_strips) {  // in flight while this strip is worked
      px_next = load_px(s + gridDim.x);
      meta_next = load_meta(s + gridDim.x);
      io_next = load_io(s + gridDim.x);
    }

    // front end: the strip's side data, then the row pass of row r of
    // block b (the pixels themselves in io and passthru)
    if (tid < n) {
      s_diff[tid] = meta.x;
      s_cls[tid] = meta.y;
      s_valid[tid] = meta.z;
      s_sel[tid] = meta.w;
    }
    if (b < n) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = (float)(((k < 4 ? px.x : px.y) >> (8 * (k & 3))) & 255u);
      float* t = &tile[b * kTile + r * kRowPitch];
      if (kDoDct) {
        fdct8_row(x, t);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = x[k];
      }
    }
    __syncthreads();
    if (kDoDct) {  // column pass: column u = r of block b, in place
      if (b < n) fdct8_col<kRowPitch>(&tile[b * kTile + r]);
      __syncthreads();
    }

    if (STOP == kIo) {
      // pixel 0 and diff of the first block of the group of kIoGroup,
      // loaded with the strip
      for (int bb = warp; bb < n; bb += kWarps) {
        for (int w = lane; w < cap_words; w += 32) {
          if (staged) s_out[bb * cap_words + w] = io.x;
          else words[(first + bb) * cap_words + w] = io.x;
        }
        if (lane == 0) s_bits[bb] = (int)io.y;
      }
    } else if (!kWalk) {
      // the pair-row modes: a warp per block; the warp of a pair's left
      // block e (warps of even index) writes blocks e and e + 1
      for (int bb = warp; bb < n; bb += kWarps) {
        int2 v = values(bb);
        uint32_t va = (uint32_t)v.x, vb = (uint32_t)v.y;
        int ba = v.x, bbits = v.y;
        if (STOP == kSynth) {  // the DC value is the given difference
          if (lane == 0) v.x = s_diff[bb];
          ba = category(v.x);
          bbits = category(v.y);
          va = (value_bits(v.x) & ((1u << ba) - 1u)) + (uint32_t)ba;
          vb = (value_bits(v.y) & ((1u << bbits) - 1u)) + (uint32_t)bbits;
        }
        if (bb & 1) {  // warp-uniform: a right block's values stay unread
          keep(make_int2((int)va, (int)vb));
          continue;
        }
        // value j = 2 lane + k of block bb is word w of block bb + h, j =
        // h cap_words + w; words past the 8 values are zero (the staged
        // rows are zero already)
        if (lane < kPairVals / 2) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int j = 2 * lane + k;
            const int h = j < cap_words ? 0 : 1;
            const int w = j - h * cap_words;
            if (w < cap_words && bb + h < n) {
              if (staged) s_out[(bb + h) * cap_words + w] = k ? vb : va;
              else words[(first + bb + h) * cap_words + w] = k ? vb : va;
            }
          }
          if (lane == 0) {
            s_bits[bb] = ba;
            if (bb + 1 < n) s_bits[bb + 1] = bbits;
          }
        }
        if (!staged) {  // cap_words > kPairVals: all 8 values in block bb
          for (int w = kPairVals + lane; w < cap_words; w += 32)
            words[(first + bb) * cap_words + w] = 0u;
          for (int w = lane; w < cap_words && bb + 1 < n; w += 32)
            words[(first + bb + 1) * cap_words + w] = 0u;
        }
      }
    } else {
      for (int bb = warp; bb < n; bb += kWarps) {
        if (!s_valid[bb]) {  // warp-uniform: no string
          if (lane == 0) s_bits[bb] = 0;
          continue;
        }
        const LaneFields f = walk_fields<STOP == kLookups>(
            values(bb), s_diff[bb], s_cls[bb], lane, s_ac, s_dc);
        const long long i = first + bb;
        if (STOP == kFull && f.total <= 64) {  // warp-uniform
          const uint2 w = place_reg(f);
          if (lane < min((f.total + 31) >> 5, cap_words)) {
            const uint32_t wl = lane ? w.y : w.x;
            if (staged) s_out[bb * cap_words + lane] = wl;
            else words[i * cap_words + lane] = wl;
          }
        } else if (staged) {
          place_row<STOP == kLookups>(&s_out[bb * cap_words], cap_words, f);
        } else {
          const int rcap = min(cap_words, kRow);
          uint32_t* row = s_row[warp];
          place_row<STOP == kLookups>(row, rcap, f);
          __syncwarp();
          const int n_words = min((f.total + 31) >> 5, rcap);
          for (int w = lane; w < n_words; w += 32) {
            words[i * cap_words + w] = row[w];
            row[w] = 0u;
          }
          __syncwarp();
        }
        if (lane == 0) s_bits[bb] = f.total;
      }
    }
    __syncthreads();

    // stores: the staged rows as one run, the bits; each thread zeroes
    // the staged words it stored for the next strip, whose walk starts
    // after that strip's first barrier
    if (staged) {
      uint32_t* dst = words + first * cap_words;
      for (int e = tid; e < n * cap_words; e += kThreads) {
        dst[e] = s_out[e];
        s_out[e] = 0u;
      }
    }
    if (tid < n) bits[first + tid] = s_bits[tid];
  }
}

template <int STOP>
int launch(const void* blocks, int NB, const void* diff, const void* cls,
           const void* valid, const void* qsel, const void* qdiv,
           const void* bias, const void* ac512, const void* dc64,
           int cap_words, void* words, void* bits, cudaStream_t stream) {
  long long ctas = ((long long)NB + kTB - 1) / kTB;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  const int vec = (uintptr_t)blocks % 8 == 0;
  if (ctas > 0)
    dct_huffman_blocks_kernel<STOP><<<(unsigned)ctas, kThreads, 0, stream>>>(
        (const uint8_t*)blocks, vec, NB, (const int32_t*)diff,
        (const int32_t*)cls, (const int32_t*)valid, (const int32_t*)qsel,
        (const float*)qdiv, (const float*)bias, (const int32_t*)ac512,
        (const int32_t*)dc64, cap_words, (uint32_t*)words, (int32_t*)bits);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, int, const void*, const void*,
                       const void*, const void*, const void*, const void*,
                       const void*, const void*, int, void*, void*,
                       cudaStream_t);

// indexed by Stop
constexpr Launch kLaunch[] = {
    launch<kIo>,  launch<kPassthru>, launch<kDctOnly>, launch<kDct>,
    launch<kDctMul>, launch<kSynth>, launch<kLookups>, launch<kFull>};

}  // namespace

extern "C" int gj_dct_huffman_blocks(const void* blocks, int NB,
                                     const void* diff, const void* cls,
                                     const void* valid, const void* qsel,
                                     const void* qdiv,
                                     const void* bias, const void* ac512,
                                     const void* dc64, int cap_words,
                                     int stop, void* words, void* bits,
                                     void* stream) {
  if (stop < 0 || stop >= (int)(sizeof(kLaunch) / sizeof(kLaunch[0])) ||
      cap_words < 1 || NB < 0)
    return (int)cudaErrorInvalidValue;
  return kLaunch[stop](blocks, NB, diff, cls, valid, qsel, qdiv, bias, ac512,
                       dc64, cap_words, words, bits, (cudaStream_t)stream);
}
