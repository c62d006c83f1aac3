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
// divisor row `qsel`; divisors qdiv (n_q, 64) f32; the zig-zag DCT
// operator (64, 64) with its level-shift bias (64,); the packed Annex-K
// tables ac512 and dc64 (`code << 5 | len`). Output: words (NB, cap_words)
// and bits (NB,).
//
// STOP = kFull (E12). q = rint((x @ dct - bias) / qdiv[qsel]) with E1p's
// numerics exactly (k-order fmaf from 0, one rounded subtraction, IEEE
// `__fdiv_rn`, `rintf` half-to-even), so E12 and E1p give the same
// quotients. Then E2's walk with three differences: the DC symbol codes
// `diff`, the DC table index is min(cat, 15) (as K12's), and a block with
// valid == 0 writes no words and has bits 0. An EOB follows when
// q[63] == 0. At most cap_words words of the string are written; bits is
// the full length (cap_words = W is K12's contract, truncation included;
// cap_words = 56 is E2's layout). Words past ceil(min(bits, 32 cap_words)
// / 32) are left as they were.
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
//              of its CTA's 64 (the script's io at a tile of 64 blocks:
//              it writes the tile's first pixel), bits[b] that block's diff;
//   kLookups   the kFull walk with the DC and AC symbols' entries from
//              arithmetic, entry = sym * 3 + cls (sym = cat for the DC, run
//              << 4 | cat for an AC symbol; ZRL and EOB from the tables),
//              and each field (code << cat | value bits, len + cat bits,
//              neither cut to its length) placed by K12's window formula
//              (WindowSink); a block with valid == 0 as in kFull.
// Only kLookups and kFull read `valid`.
//
// Design (simple first): a CTA of 64 threads takes kBlocks = 64 blocks at
// a time. It stages their pixels in shared memory as floats; thread p then
// computes zig-zag coefficient p of each of the 64 blocks, with DCT column
// p held in 64 registers (E1p's design, reading four pixels per shared
// load), and writes the mode's value to shared memory (rows padded to 65
// words, so the walk's column reads fall in distinct banks). After a
// barrier thread t walks block t. The grid strides over the blocks so that
// each CTA loads its DCT column once.
//
// What bounds it: at 8K (1,555,200 blocks, W = 4) the DCT's operations,
// 2,176 a block in separable form (0.051 ms at 67 TFLOP/s), over the
// bytes (~155 MB, 0.046 ms). This design does the dense product, 8,192
// operations a block, and the walk is serial and divergent within a warp;
// both are work for a later PR.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsink.cuh"

namespace {

constexpr int kBlocks = 64;  // blocks per CTA iteration: one per thread
constexpr int kXPitch = 68;  // floats per staged pixel row (16-byte rows)
constexpr int kQPitch = 65;  // words per value row (bank-conflict free)
constexpr int kPairVals = 8; // values the script writes per pair row

enum Stop {
  kIo = 0, kPassthru, kDctOnly, kDct, kDctMul, kSynth, kLookups, kFull
};

// K12's placement of a field (ablate_stage1.py kernel_body, the `r`, `j`,
// `s0`, `part0`, `part1` lines): a field (val, ln) at bit offset `total`
// is ORed into word total / 32, shifted left by s0 = 32 - total % 32 - ln
// (right by -s0, at most 31, when s0 < 0, the spill shifted left by
// max(32 + s0, 0) into the next word). For val < 2^ln <= 2^32 that is the
// BitSink's string; it also defines the string of fields that break that.
struct WindowSink {
  uint32_t* out;
  int cap_words;
  uint32_t cur = 0, nxt = 0;  // words j and j + 1
  int j = 0;
  int total = 0;  // offset of the next field

  __device__ void put(uint32_t val, int ln) {
    if (ln == 0) return;
    for (const int jj = total >> 5; j < jj; ++j) {
      if (j < cap_words) out[j] = cur;
      cur = nxt;
      nxt = 0;
    }
    const int s0 = 32 - (total & 31) - ln;
    if (s0 >= 0) {
      cur |= val << s0;
    } else {
      cur |= val >> min(-s0, 31);
      nxt |= val << max(32 + s0, 0);
    }
    total += ln;
  }

  // Write every word up to ceil(total / 32) (a field longer than 32 bits
  // leaves a zero word past its spill).
  __device__ void flush() {
    for (; j < cap_words && 32 * j < total; ++j) {
      out[j] = cur;
      cur = nxt;
      nxt = 0;
    }
  }
};

__device__ __forceinline__ int dc_entry_of(const int32_t* __restrict__ dc64,
                                           int stop, int cls, int cat) {
  return stop == kLookups ? cat * 3 + cls : dc64[cls * 32 + min(cat, 15)];
}

__device__ __forceinline__ int ac_entry_of(const int32_t* __restrict__ ac512,
                                           int stop, int cls, int sym) {
  return stop == kLookups ? sym * 3 + cls : ac512[cls * 256 + sym];
}

// Put one entry's code followed by `cat` value bits of v.
template <class Sink>
__device__ __forceinline__ void put_symbol(Sink& sink, int e, int v,
                                           int cat) {
  sink.put((((uint32_t)e >> 5) << cat) |
               (value_bits(v) & ((1u << cat) - 1u)),
           (e & 31) + cat);
}

template <int STOP, class Sink>
__device__ void walk(const int32_t* q, int dv, int cls,
                     const int32_t* __restrict__ ac512,
                     const int32_t* __restrict__ dc64, Sink& sink) {
  int cat = category(dv);
  put_symbol(sink, dc_entry_of(dc64, STOP, cls, cat), dv, cat);
  int run = 0;
  for (int j = 1; j < 64; ++j) {
    const int v = q[j];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) {
      const int z = ac512[cls * 256 + 0xF0];
      sink.put((uint32_t)z >> 5, z & 31);
    }
    cat = category(v);
    put_symbol(sink, ac_entry_of(ac512, STOP, cls, (run << 4) | cat), v,
               cat);
    run = 0;
  }
  if (run > 0) {
    const int z = ac512[cls * 256];
    sink.put((uint32_t)z >> 5, z & 31);
  }
  sink.flush();
}

template <int STOP>
__global__ void __launch_bounds__(kBlocks)
dct_huffman_blocks_kernel(const uint8_t* __restrict__ blocks, int NB,
                          const int32_t* __restrict__ diff,
                          const int32_t* __restrict__ cls,
                          const int32_t* __restrict__ valid,
                          const int32_t* __restrict__ qsel,
                          const float* __restrict__ qdiv,  // (n_q, 64)
                          const float* __restrict__ dct,   // (64, 64)
                          const float* __restrict__ bias,  // (64,)
                          const int32_t* __restrict__ ac512,
                          const int32_t* __restrict__ dc64, int cap_words,
                          uint32_t* __restrict__ words,
                          int32_t* __restrict__ bits) {
  constexpr bool kDoDct = STOP != kIo && STOP != kPassthru;
  __shared__ __align__(16) float xs[kBlocks][kXPitch];
  __shared__ int32_t qs[kBlocks][kQPitch];
  __shared__ int sel[kBlocks];
  __shared__ int sd[kBlocks];
  const int p = threadIdx.x;  // pixel/coefficient p, then block p's walker

  float d[64];
  float b = 0.f;
  if (kDoDct) {
#pragma unroll
    for (int k = 0; k < 64; ++k) d[k] = dct[k * 64 + p];
    b = bias[p];
  }

  for (long long first = (long long)blockIdx.x * kBlocks; first < NB;
       first += (long long)gridDim.x * kBlocks) {
    const int nb = (int)min((long long)kBlocks, (long long)NB - first);
    __syncthreads();  // the previous iteration is done with xs, qs, sel, sd
    const uint8_t* src = blocks + first * 64;
    for (int g = 0; g < nb; ++g) xs[g][p] = (float)src[g * 64 + p];
    if (p < nb) {
      sel[p] = qsel[first + p];
      sd[p] = diff[first + p];
    }
    __syncthreads();

    if (kDoDct) {
      for (int g = 0; g < nb; ++g) {
        const float4* x4 = reinterpret_cast<const float4*>(xs[g]);
        float acc = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < 16; ++k4) {
          const float4 x = x4[k4];
          acc = fmaf(x.x, d[4 * k4], acc);
          acc = fmaf(x.y, d[4 * k4 + 1], acc);
          acc = fmaf(x.z, d[4 * k4 + 2], acc);
          acc = fmaf(x.w, d[4 * k4 + 3], acc);
        }
        const float y = __fsub_rn(acc, b);
        const float qd = qdiv[sel[g] * 64 + p];
        int v;
        if (STOP == kDctOnly) v = (int)y;
        else if (STOP == kDctMul) v = (int)rintf(__fmul_rn(y, qd));
        else v = (int)rintf(__fdiv_rn(y, qd));
        qs[g][p] = v;
      }
      __syncthreads();
    }
    if (p >= nb) continue;

    const long long i = first + p;
    uint32_t* out = words + i * cap_words;
    if (STOP == kIo) {
      const uint32_t px = (uint32_t)xs[0][0];
      for (int w = 0; w < cap_words; ++w) out[w] = px;
      bits[i] = sd[0];
    } else if (STOP == kLookups || STOP == kFull) {
      if (!valid[i]) {
        bits[i] = 0;
      } else if (STOP == kLookups) {
        WindowSink sink{out, cap_words};
        walk<STOP>(qs[p], sd[p], cls[i], ac512, dc64, sink);
        bits[i] = sink.total;
      } else {
        BitSink sink{out, cap_words};
        walk<STOP>(qs[p], sd[p], cls[i], ac512, dc64, sink);
        bits[i] = sink.total;
      }
    } else {
      // the pair-row modes: values of the pair's left block e
      const int e = p & ~1, h = p & 1;
      auto val = [&](int j, bool of_bits) -> uint32_t {
        if (STOP == kPassthru) return (uint32_t)xs[e][j];
        if (STOP != kSynth) return (uint32_t)qs[e][j];
        const int v = j ? qs[e][j] : sd[e];
        const int c = category(v);
        if (of_bits) return (uint32_t)c;
        return (value_bits(v) & ((1u << c) - 1u)) + (uint32_t)c;
      };
      for (int w = 0; w < cap_words; ++w) {
        const int j = h * cap_words + w;
        out[w] = j < kPairVals ? val(j, false) : 0u;
      }
      bits[i] = (int32_t)val(h, true);
    }
  }
}

template <int STOP>
int launch(const void* blocks, int NB, const void* diff, const void* cls,
           const void* valid, const void* qsel, const void* qdiv,
           const void* dct, const void* bias, const void* ac512,
           const void* dc64, int cap_words, void* words, void* bits,
           cudaStream_t stream) {
  long long ctas = ((long long)NB + kBlocks - 1) / kBlocks;
  if (ctas > 132 * 8) ctas = 132 * 8;  // grid-stride beyond ~8 CTAs/SM
  if (ctas > 0)
    dct_huffman_blocks_kernel<STOP><<<(unsigned)ctas, kBlocks, 0, stream>>>(
        (const uint8_t*)blocks, NB, (const int32_t*)diff,
        (const int32_t*)cls, (const int32_t*)valid, (const int32_t*)qsel,
        (const float*)qdiv, (const float*)dct, (const float*)bias,
        (const int32_t*)ac512, (const int32_t*)dc64, cap_words,
        (uint32_t*)words, (int32_t*)bits);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, int, const void*, const void*,
                       const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, int, void*,
                       void*, cudaStream_t);

// indexed by Stop
constexpr Launch kLaunch[] = {
    launch<kIo>,  launch<kPassthru>, launch<kDctOnly>, launch<kDct>,
    launch<kDctMul>, launch<kSynth>, launch<kLookups>, launch<kFull>};

}  // namespace

extern "C" int gj_dct_huffman_blocks(const void* blocks, int NB,
                                     const void* diff, const void* cls,
                                     const void* valid, const void* qsel,
                                     const void* qdiv, const void* dct,
                                     const void* bias, const void* ac512,
                                     const void* dc64, int cap_words,
                                     int stop, void* words, void* bits,
                                     void* stream) {
  if (stop < 0 || stop >= (int)(sizeof(kLaunch) / sizeof(kLaunch[0])))
    return (int)cudaErrorInvalidValue;
  return kLaunch[stop](blocks, NB, diff, cls, valid, qsel, qdiv, dct, bias,
                       ac512, dc64, cap_words, words, bits,
                       (cudaStream_t)stream);
}
