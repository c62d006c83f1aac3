// D1L huffman_lanes: the Huffman decode of scans without restart markers,
// each scan one long segment, by self-synchronising lanes.
//
// Input: D1's rows (S, wcap) of destuffed big-endian u32 words, one segment
// a row (S <= 4: one interleaved scan, or one scan a component), D1's tables
// and slot maps, and the lane geometry `LaneGeo` (`decode.lane_geometry`):
// each segment's data bits, first block, block count, blocks per MCU and the
// component of each block of an MCU, and its lanes. Output: D1's (NB, 64)
// int32 zig-zag coefficients in scan order, DC values (not differences),
// every block written whole; the same values as D1 run on the same rows
// (one thread a segment), bit for bit, corrupt streams included.
//
// A segment's bits are cut into lanes of `lane_bits`. The decode's state at
// a symbol boundary is (bit, phase: the block's place in its MCU, k: the
// zig-zag index); lane j of a segment starts from a guess (j * lane_bits,
// 0, 0), lane 0 from the exact (0, 0, 0). Two kernels:
//   * settle (one cooperative launch): every lane decodes from its start to
//     the first symbol boundary at or past the next lane's first bit, and
//     that end becomes the next lane's start; lanes whose start moved decode
//     again, round after round, a grid-wide sync between, until no start
//     moves. Huffman codes resynchronise within a few symbols, so most lanes
//     settle in the first rounds; since lane 0 is exact, round r makes lane
//     r exact at the latest, so the loop, bounded on the device by the most
//     lanes of one segment, always ends. Nothing is read back to the host.
//     A lane's last run also counts the blocks it completed and sums its DC
//     differences per component; after the rounds the same grid sums those
//     over the lanes before each lane (each CTA its run of lanes, then the
//     runs' totals): with those of its segment's first lane taken off, the
//     block in progress at each lane's start and the DC predictors there;
//   * write: each lane owns the blocks whose DC symbol lies in its bits,
//     finishes (unwritten) the block in progress at its start, then decodes
//     its blocks as D1 does, into zeroed shared rows that the warp writes
//     out whole; the last lane of a segment decodes up to its block count.
// A lane reads its row a 16-byte chunk ahead of the bits it decodes, as D1
// does. Corrupt-stream guards are D1's: reads past a row's wcap words see
// zeros, an invalid code is symbol 0 of one bit, a position past 63 writes
// nothing. The number of rounds goes to `scratch`'s flags (the
// `gpujpeg.dec.rounds` counter).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "huffman_sym.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSeg = 4;
constexpr int kMaxPhase = 10;  // blocks of an MCU (T.81: at most 10)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGrid = 4096;  // CTAs of the settle (their totals' room)
constexpr int kRow4 = 17;  // int4s of a lane's row: 64 ints + 4 spread banks
constexpr unsigned kFull = 0xffffffffu;

// `decode.lane_geometry`'s int32 array, field for field
struct LaneGeo {
  int n_seg, n_lanes, lane_bits, max_lanes;
  int lane0[kMaxSeg + 1];  // first lane of each segment; lane0[n_seg] = n_lanes
  int bits[kMaxSeg];       // the segment's data bits
  int start[kMaxSeg], count[kMaxSeg], bpm[kMaxSeg];
  int comp[kMaxSeg * kMaxPhase];  // component of block p of an MCU
};

// the lane state in `scratch`: fields of n_lanes ints each, then 4 flags
// (the last the rounds), then 5 totals of each CTA of the settle
enum {
  kSBit,  // start bit
  kSPk,   // start phase << 6 | k
  kEBit,  // the last run's end
  kEPk,
  kNBlk,  // blocks the last run completed
  kDc,    // 4 fields: the last run's DC differences summed per component
  kTodo = kDc + 4,
  kBlk0,  // the blocks completed before the lane's start, over the scan
  kCarry,  // 4 fields: the DC differences summed before it, over the scan
  kFields = kCarry + 4
};

struct Tab {
  uint16_t wide[kMaxSlots << kWideBits];
  int huffval[kMaxSlots * 256];
  int maxcode[kMaxSlots * 18];
  int delta[kMaxSlots * 17];
  int dc[4], ac[4];
  int comp[kMaxSeg * kMaxPhase];
};

struct WriteSmem {
  int4 blk[kWarps][32 * kRow4];
  Tab t;
};

__device__ void load_tables(Tab& t, const LaneGeo& g,
                            const int32_t* __restrict__ wide,
                            const int32_t* __restrict__ maxcode,
                            const int32_t* __restrict__ delta,
                            const int32_t* __restrict__ huffval,
                            const int32_t* __restrict__ dc_slot,
                            const int32_t* __restrict__ ac_slot, int n_slots) {
  for (int i = threadIdx.x; i < (n_slots << kWideBits); i += blockDim.x)
    t.wide[i] = (uint16_t)wide[i];
  for (int i = threadIdx.x; i < n_slots * 256; i += blockDim.x)
    t.huffval[i] = huffval[i];
  for (int i = threadIdx.x; i < n_slots * 18; i += blockDim.x)
    t.maxcode[i] = maxcode[i];
  for (int i = threadIdx.x; i < n_slots * 17; i += blockDim.x)
    t.delta[i] = delta[i];
  for (int i = threadIdx.x; i < kMaxSeg * kMaxPhase; i += blockDim.x)
    t.comp[i] = g.comp[i];
  if (threadIdx.x < 4) {
    t.dc[threadIdx.x] = dc_slot[threadIdx.x];
    t.ac[threadIdx.x] = ac_slot[threadIdx.x];
  }
}

// The segment of lane `l`.
__device__ __forceinline__ int seg_of(const LaneGeo& g, int l) {
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i) s += (i < g.n_seg) & (l >= g.lane0[i]);
  return s;
}

// A bit reader from any bit of row `s` of rows that start on a 16-byte
// boundary: `acc` holds the next `nb` bits MSB first; `cur` the rest of the
// current chunk (`ncur` words), `nxt` the next chunk, loaded when the
// current one is taken (D1's reader); `wp` the row's index of the next word
// handed out. Words past `wcap` read as zero.
struct Bits {
  const uint32_t* rows;
  long long ch, row_end, total, wp;
  int wcap, ncur, nb;
  uint4 cur, nxt;
  uint64_t acc;

  __device__ __forceinline__ void refill() {
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
  }
  __device__ __forceinline__ void init(const uint32_t* r, int n_rows, int wc,
                                       int s, long long bit) {
    rows = r;
    wcap = wc;
    total = (long long)n_rows * wc;
    const long long row0 = (long long)s * wc;
    row_end = row0 + wc;
    wp = bit >> 5;
    const long long g = row0 + (wp < wc ? wp : wc);
    ch = g >> 2;
    cur = load_chunk(rows, ch++, row_end, total);
    nxt = load_chunk(rows, ch++, row_end, total);
    ncur = 4;
    for (int i = 0; i < (int)(g & 3); ++i) {
      cur.x = cur.y; cur.y = cur.z; cur.z = cur.w;
      --ncur;
    }
    acc = 0;
    nb = 0;
    refill();
    const int sh = (int)(bit & 31);
    acc <<= sh;
    nb -= sh;
  }
  __device__ __forceinline__ void skip(int n) {
    while (n > 0) {
      refill();
      const int t = n < 32 ? n : 32;
      acc <<= t;
      nb -= t;
      n -= t;
    }
  }
};

// One symbol of component `comp` at zig-zag index `k`: (cat, run, value)
// and the bits it took (code and value bits).
__device__ __forceinline__ int next_symbol(const Tab& t, Bits& b, int comp,
                                           int k, int& cat, int& run,
                                           int& val) {
  b.refill();
  const uint32_t view = (uint32_t)(b.acc >> 32);
  const bool is_dc = k == 0;
  int sym, ln;
  lookup_sym(t.wide, t.maxcode, t.delta, t.huffval,
             is_dc ? t.dc[comp] : t.ac[comp], view, sym, ln);
  cat = is_dc ? sym : (sym & 15);
  run = is_dc ? 0 : (sym >> 4);
  val = extend_value(view, ln, cat);
  b.skip(ln + cat);
  return ln + cat;
}

// k after a symbol at k (>= 64: the block is done)
__device__ __forceinline__ int next_k(int k, int cat, int run) {
  if (k == 0) return 1;
  if (cat == 0) return run == 15 ? k + 16 : 64;  // ZRL or EOB
  return k + run + 1;
}

__device__ __forceinline__ void add_dc(int comp, int val, unsigned& d0,
                                       unsigned& d1, unsigned& d2,
                                       unsigned& d3) {
  d0 += comp == 0 ? (unsigned)val : 0u;
  d1 += comp == 1 ? (unsigned)val : 0u;
  d2 += comp == 2 ? (unsigned)val : 0u;
  d3 += comp == 3 ? (unsigned)val : 0u;
}

// Exclusive sum over lanes of `v` (unsigned, wrapping) within a full warp.
__device__ __forceinline__ unsigned warp_exclusive(unsigned v, int lane) {
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += n;
  }
  return x - v;
}

// The settle's last part, on the whole grid: each lane's exclusive sums of
// the blocks completed and the DC differences (5 values, unsigned,
// wrapping) over the lanes before it. Each CTA sums a run of consecutive
// lanes in tiles of its threads, the runs' totals are summed across the
// grid by CTA 0 (a warp a value), then each CTA adds its run's offset.
__device__ void exclusive_sums(cg::grid_group& grid, int L, int* st,
                               unsigned* tot) {
  __shared__ unsigned wsum[5][kWarps], run[5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  const int per = (L + G - 1) / G;
  const int c0 = min(L, (int)blockIdx.x * per), c1 = min(L, c0 + per);
  if (threadIdx.x < 5) run[threadIdx.x] = 0;
  __syncthreads();
  for (int base = c0; base < c1; base += kThreads) {
    const int l = base + threadIdx.x;
    unsigned v[5] = {0u, 0u, 0u, 0u, 0u}, ex[5];
    if (l < c1) {
      v[0] = (unsigned)__ldcg(st + kNBlk * L + l);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[1 + c] = (unsigned)__ldcg(st + (kDc + c) * L + l);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      ex[i] = warp_exclusive(v[i], lane);
      if (lane == 31) wsum[i][warp] = ex[i] + v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      unsigned before = run[i];
      for (int w = 0; w < warp; ++w) before += wsum[i][w];
      ex[i] += before;
    }
    if (l < c1) {
      st[kBlk0 * L + l] = (int)ex[0];
#pragma unroll
      for (int c = 0; c < 4; ++c) st[(kCarry + c) * L + l] = (int)ex[1 + c];
    }
    __syncthreads();
    if (threadIdx.x < 5) {
      unsigned t = 0;
      for (int w = 0; w < kWarps; ++w) t += wsum[threadIdx.x][w];
      run[threadIdx.x] += t;
    }
    __syncthreads();
  }
  if (threadIdx.x < 5) tot[threadIdx.x * G + blockIdx.x] = run[threadIdx.x];
  grid.sync();
  if (blockIdx.x == 0) {
    for (int i = warp; i < 5; i += kWarps) {
      unsigned carry = 0;
      for (int b = 0; b < G; b += 32) {
        const unsigned x = b + lane < G ? __ldcg(tot + i * G + b + lane) : 0u;
        const unsigned ex = warp_exclusive(x, lane) + carry;
        if (b + lane < G) tot[i * G + b + lane] = ex;
        carry = __shfl_sync(kFull, ex + x, 31);
      }
    }
  }
  grid.sync();
  unsigned off[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) off[i] = __ldcg(tot + i * G + blockIdx.x);
  for (int l = c0 + threadIdx.x; l < c1; l += kThreads) {
    st[kBlk0 * L + l] = (int)((unsigned)st[kBlk0 * L + l] + off[0]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st[(kCarry + c) * L + l] =
          (int)((unsigned)st[(kCarry + c) * L + l] + off[1 + c]);
  }
}

__global__ void __launch_bounds__(kThreads)
huffman_lanes_settle(LaneGeo g, const uint32_t* __restrict__ rows, int wcap,
                     const int32_t* __restrict__ wide,
                     const int32_t* __restrict__ maxcode,
                     const int32_t* __restrict__ delta,
                     const int32_t* __restrict__ huffval,
                     const int32_t* __restrict__ dc_slot,
                     const int32_t* __restrict__ ac_slot, int n_slots,
                     int* __restrict__ st) {
  extern __shared__ int4 smem4[];
  Tab& t = *reinterpret_cast<Tab*>(smem4);
  load_tables(t, g, wide, maxcode, delta, huffval, dc_slot, ac_slot, n_slots);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int L = g.n_lanes;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int* f = st + (size_t)kFields * L;  // flags; f[3] the rounds
  for (int l = tid; l < L; l += stride) {
    const int s = seg_of(g, l);
    const int bit = (l - g.lane0[s]) * g.lane_bits;
    st[kSBit * L + l] = bit;
    st[kSPk * L + l] = 0;
    st[kEBit * L + l] = bit;
    st[kEPk * L + l] = 0;
    st[kNBlk * L + l] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) st[(kDc + c) * L + l] = 0;
    st[kTodo * L + l] = l != g.lane0[s + 1] - 1;  // the last lane never runs
  }
  if (tid == 0) f[0] = f[1] = f[2] = 0;
  grid.sync();
  int r = 0;
  while (r < g.max_lanes) {
    ++r;
    for (int l = tid; l < L; l += stride) {
      if (!st[kTodo * L + l]) continue;
      st[kTodo * L + l] = 0;
      const int s = seg_of(g, l);
      const int stop = (l - g.lane0[s] + 1) * g.lane_bits;
      const int bpm = g.bpm[s];
      const int* comps = t.comp + s * kMaxPhase;
      int pos = st[kSBit * L + l];
      const int pk = st[kSPk * L + l];
      int phase = pk >> 6, k = pk & 63, nblk = 0;
      int comp = comps[phase];
      unsigned d0 = 0, d1 = 0, d2 = 0, d3 = 0;
      Bits b;
      b.init(rows, g.n_seg, wcap, s, pos);
      while (pos < stop) {
        int cat, run, val;
        pos += next_symbol(t, b, comp, k, cat, run, val);
        if (k == 0) add_dc(comp, val, d0, d1, d2, d3);
        k = next_k(k, cat, run);
        if (k >= 64) {
          k = 0;
          ++nblk;
          phase = phase + 1 == bpm ? 0 : phase + 1;
          comp = comps[phase];
        }
      }
      st[kEBit * L + l] = pos;
      st[kEPk * L + l] = phase << 6 | k;
      st[kNBlk * L + l] = nblk;
      st[(kDc + 0) * L + l] = (int)d0;
      st[(kDc + 1) * L + l] = (int)d1;
      st[(kDc + 2) * L + l] = (int)d2;
      st[(kDc + 3) * L + l] = (int)d3;
    }
    grid.sync();
    if (tid == 0) f[(r + 1) % 3] = 0;  // the next round's flag
    int again = 0;
    for (int l = tid; l < L; l += stride) {
      const int s = seg_of(g, l);
      if (l == g.lane0[s]) continue;  // a segment's first lane is exact
      const int eb = __ldcg(st + kEBit * L + l - 1);
      const int ep = __ldcg(st + kEPk * L + l - 1);
      if (eb != st[kSBit * L + l] || ep != st[kSPk * L + l]) {
        st[kSBit * L + l] = eb;
        st[kSPk * L + l] = ep;
        if (l != g.lane0[s + 1] - 1) {
          st[kTodo * L + l] = 1;
          again = 1;
        }
      }
    }
    if (__syncthreads_or(again) && threadIdx.x == 0) atomicOr(f + r % 3, 1);
    grid.sync();
    if (*reinterpret_cast<volatile int*>(f + r % 3) == 0) break;
  }
  if (tid == 0) f[3] = r;
  exclusive_sums(grid, L, st, reinterpret_cast<unsigned*>(f + 4));
}

__global__ void __launch_bounds__(kThreads)
huffman_lanes_write(LaneGeo g, const uint32_t* __restrict__ rows, int wcap,
                    const int32_t* __restrict__ wide,
                    const int32_t* __restrict__ maxcode,
                    const int32_t* __restrict__ delta,
                    const int32_t* __restrict__ huffval,
                    const int32_t* __restrict__ dc_slot,
                    const int32_t* __restrict__ ac_slot, int n_slots,
                    const int* __restrict__ st, int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  WriteSmem& sm = *reinterpret_cast<WriteSmem*>(smem4);
  const Tab& t = sm.t;
  load_tables(sm.t, g, wide, maxcode, delta, huffval, dc_slot, ac_slot,
              n_slots);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* rowbuf = sm.blk[warp];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    rowbuf[(2 * j + (lane >> 4)) * kRow4 + (lane & 15)] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int L = g.n_lanes;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int s = l < L ? seg_of(g, l) : 0;
  const int count = g.count[s];
  // the blocks whose DC symbol lies in the lane's bits: [first, end), in
  // its segment (the sums over the scan less those of its first lane)
  const int a = g.lane0[s];
  int first = 0, n_own = 0, pk = 0;
  if (l < L) {
    const int blk0 = st[kBlk0 * L + a];
    pk = st[kSPk * L + l];
    first = st[kBlk0 * L + l] - blk0 + ((pk & 63) > 0);
    const int end =
        l == g.lane0[s + 1] - 1
            ? count
            : min(count, st[kBlk0 * L + l + 1] - blk0 +
                             ((st[kSPk * L + l + 1] & 63) > 0));
    n_own = max(0, end - first);
  }
  const int max_own = __reduce_max_sync(kFull, n_own);
  if (max_own <= 0) return;

  const int bpm = g.bpm[s];
  const int* comps = t.comp + s * kMaxPhase;
  int phase = pk >> 6, k = pk & 63;
  Bits b;
  if (n_own > 0) {
    b.init(rows, g.n_seg, wcap, s, st[kSBit * L + l]);
    if (k > 0) {  // the block in progress: its earlier lane's
      const int comp = comps[phase];
      while (k < 64) {
        int cat, run, val;
        next_symbol(t, b, comp, k, cat, run, val);
        k = next_k(k, cat, run);
      }
      phase = phase + 1 == bpm ? 0 : phase + 1;
    }
  }
  // the DC predictors at the lane's first block
  int dc[4] = {0, 0, 0, 0};
  if (n_own > 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dc[c] = (int)((unsigned)st[(kCarry + c) * L + l] -
                    (unsigned)st[(kCarry + c) * L + a]);
  }
  int dc0 = dc[0], dc1 = dc[1], dc2 = dc[2], dc3 = dc[3];
  int* o = reinterpret_cast<int*>(rowbuf + lane * kRow4);
  const int base = g.start[s] + first;
  for (int i = 0; i < max_own; ++i) {
    if (i < n_own) {
      const int comp = comps[phase];
      k = 0;
      while (k < 64) {
        int cat, run, val;
        next_symbol(t, b, comp, k, cat, run, val);
        if (k == 0) {
          const int pred =
              comp == 0 ? dc0 : comp == 1 ? dc1 : comp == 2 ? dc2 : dc3;
          const int now = (int)((uint32_t)pred + (uint32_t)val);
          dc0 = comp == 0 ? now : dc0;
          dc1 = comp == 1 ? now : dc1;
          dc2 = comp == 2 ? now : dc2;
          dc3 = comp == 3 ? now : dc3;
          o[0] = now;
        } else if (cat > 0) {
          const int at = k + run;
          if (at <= 63) o[at] = val;
        }
        k = next_k(k, cat, run);
      }
      phase = phase + 1 == bpm ? 0 : phase + 1;
    }
    __syncwarp();
    // the warp's blocks i, two at a time: lanes 16 h .. 16 h + 15 move the
    // 16 int4s of lane 2 j + h's row to its block and zero them
    const unsigned act = __ballot_sync(kFull, i < n_own);
    const int mine = base + i;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int Lr = 2 * j + (lane >> 4), e = lane & 15;
      const int blk = __shfl_sync(kFull, mine, Lr);
      if ((act >> Lr) & 1u) {
        int4* p = rowbuf + Lr * kRow4 + e;
        const int4 v = *p;
        *p = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(out)[(size_t)blk * 16 + e] = v;
      }
    }
    __syncwarp();
  }
}

// Per device: the most CTAs of the settle that are resident at once (0:
// not asked yet), after the write kernel's shared memory was allowed.
constexpr int kMaxDevices = 64;
std::atomic<int> resident[kMaxDevices];

cudaError_t settle_grid(int dev, int& grid) {
  if (dev >= 0 && dev < kMaxDevices && (grid = resident[dev].load()) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, huffman_lanes_settle, kThreads, (int)sizeof(Tab));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(huffman_lanes_write,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(WriteSmem));
  if (e != cudaSuccess) return e;
  grid = per_sm * sms < kMaxGrid ? per_sm * sms : kMaxGrid;
  if (dev >= 0 && dev < kMaxDevices) resident[dev].store(grid);
  return cudaSuccess;
}

bool valid(const LaneGeo& g) {
  if (g.n_seg < 1 || g.n_seg > kMaxSeg || g.lane_bits < 1 ||
      g.lane0[0] != 0 || g.lane0[g.n_seg] != g.n_lanes || g.n_lanes < 1)
    return false;
  int most = 0;
  for (int s = 0; s < g.n_seg; ++s) {
    const int n = g.lane0[s + 1] - g.lane0[s];
    if (n < 1 || g.bpm[s] < 1 || g.bpm[s] > kMaxPhase || g.count[s] < 0 ||
        g.start[s] < 0 || (long long)n * g.lane_bits > (1LL << 30))
      return false;
    for (int p = 0; p < g.bpm[s]; ++p)
      if (g.comp[s * kMaxPhase + p] < 0 || g.comp[s * kMaxPhase + p] > 3)
        return false;
    most = n > most ? n : most;
  }
  return g.max_lanes == most;
}

}  // namespace

// `rows`: on a 16-byte boundary; `geo`: host int32s in LaneGeo's order
// (read before this returns); `scratch`: device int32s, kFields * n_lanes
// + 4 + 5 * kMaxGrid (the rounds land in kFields * n_lanes + 3); `out`:
// (NB, 64) int32, every block of the segments written.
extern "C" int gj_huffman_lanes(const void* rows, int wcap, const void* geo,
                                const void* wide, const void* maxcode,
                                const void* delta, const void* huffval,
                                const void* dc_slot, const void* ac_slot,
                                int n_slots, void* scratch, void* out,
                                void* stream) {
  LaneGeo g;
  memcpy(&g, geo, sizeof(g));
  if (n_slots < 1 || n_slots > kMaxSlots || !valid(g))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)rows % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, grid = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = settle_grid(dev, grid);
  if (e != cudaSuccess) return (int)e;
  const int need = (g.n_lanes + kThreads - 1) / kThreads;
  grid = need < grid ? need : grid;
  const int smem_s = (int)sizeof(Tab), smem_w = (int)sizeof(WriteSmem);
  const uint32_t* r = (const uint32_t*)rows;
  const int32_t *w = (const int32_t*)wide, *mc = (const int32_t*)maxcode,
                *dl = (const int32_t*)delta, *hv = (const int32_t*)huffval,
                *ds = (const int32_t*)dc_slot, *as = (const int32_t*)ac_slot;
  int* sc = (int*)scratch;
  void* args[] = {&g, &r, &wcap, &w, &mc, &dl, &hv, &ds, &as, &n_slots, &sc};
  e = cudaLaunchCooperativeKernel((const void*)huffman_lanes_settle,
                                  dim3(grid), dim3(kThreads), args, smem_s,
                                  st);
  if (e != cudaSuccess) return (int)e;
  huffman_lanes_write<<<need, kThreads, smem_w, st>>>(
      g, r, wcap, w, mc, dl, hv, ds, as, n_slots, sc, (int32_t*)out);
  return (int)cudaGetLastError();
}
