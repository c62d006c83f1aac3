// copy_bytes: dst[i] = src[i] for n bytes, the card's copy rate at frame
// size.
//
// Replaces the "null" copy kernel of `scripts/perf_stage1.py` (`nullk`
// under `run`, the identity on (N/2, 128) u8 tiles), which measured the
// TPU's per-grid-step cost and copy floor. Its TPU tile sweep has no
// counterpart.
//
// What bounds it: bytes, 2n over the memory rate (199 MB at 8K, 0.059 ms
// at 3.35 TB/s). Each CTA copies one contiguous chunk of kChunk bytes:
// each thread issues kUnroll 16-byte loads, neighbouring threads on
// neighbouring addresses, before its stores, with the streaming cache
// hints (`__ldcs`/`__stcs`: the data is touched once). At 99.5 MB on an
// NVIDIA H100 80GB HBM3 (700.00 W), in turns with `Tensor.clone()` in one
// call, by CUDA events with the runs held behind a spin of the card
// (`tools.mean_ms(hold=True)`), this kernel took 0.0690 ms and clone()
// 0.0691 (2.88 TB/s; its `cudaMemcpyAsync` device to device, which the
// profiler shows as a copy, not as a kernel with a grid); the bound is
// 0.0594. By the plain events, which also take in the first launch's host
// time (the wrapper's checks and allocation), it trails: 0.0700 against
// 0.0695 in an earlier call. Forms that did no better, each against
// clone()'s 0.0687-0.0691 in its own call (the runs held; the persistent
// grids and the TMA ring by the plain events): 32 KB chunks (eight loads in
// flight) 0.0689-0.0697; 4 or 16 loads,
// 128, 512 or 1024 threads a CTA, `ld.global.nc.L1::no_allocate`, an L2
// prefetch of 256 bytes (0.0686-0.0693); no hints 0.0694-0.0695, `__ldg`
// 0.0696, the streaming loads with plain stores 0.0702-0.0703; the chunks
// in a persistent grid of 4-8 CTAs an SM 0.0694-0.0722; bulk copies (TMA)
// through a shared ring of 3-8 stages of 8-64 KB, one thread a CTA, one or
// two CTAs an SM 0.0724-0.0737; the earlier grid stride over 132 x 8 CTAs
// with four loads in flight and no hints 0.0741-0.0742. What is left to
// the bound is the DRAM's.
//
// Edges: a bulk vector needs both pointers 16-byte aligned. Where they
// share their offset from a 16-byte boundary, the head up to the boundary
// and the tail past the last whole vector (each under 16 bytes) are
// copied by CTA 0's threads one byte each; where they do not, every CTA
// copies its chunk one byte a thread at a time. Any n >= 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                         // loads in flight
constexpr int kVec = kThreads * kUnroll;           // vectors a chunk
constexpr long long kChunk = 16LL * kVec;          // bytes a chunk (8 KB)

__global__ void __launch_bounds__(kThreads)
copy_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  long long n) {
  const int t = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kChunk;
  if ((((uintptr_t)src ^ (uintptr_t)dst) & 15) != 0) {
    const long long c1 = min(c0 + kChunk, n);
    for (long long i = c0 + t; i < c1; i += kThreads) dst[i] = src[i];
    return;
  }
  const long long head = min((long long)((16 - ((uintptr_t)dst & 15)) & 15),
                             n);
  const long long n16 = (n - head) >> 4;
  const long long tail = head + 16 * n16;
  if (blockIdx.x == 0) {
    if (t < head) dst[t] = src[t];
    if (t < n - tail) dst[tail + t] = src[tail + t];
  }
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  const long long v0 = (long long)blockIdx.x * kVec + t;
  uint4 r[kUnroll];
  if ((long long)(blockIdx.x + 1) * kVec <= n16) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(s + v0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcs(d + v0 + u * kThreads, r[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < n16) r[u] = __ldcs(s + v0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < n16) __stcs(d + v0 + u * kThreads, r[u]);
  }
}

}  // namespace

// The launch of n bytes: a CTA a chunk of kChunk bytes, none for n <= 0.
extern "C" int gj_copy_bytes_grid(long long n, long long* ctas,
                                  int* threads) {
  *ctas = n > 0 ? (n + kChunk - 1) / kChunk : 0;
  *threads = kThreads;
  return *ctas > 0x7fffffffLL ? (int)cudaErrorInvalidValue : 0;
}

extern "C" int gj_copy_bytes(const void* src, void* dst, long long n,
                             void* stream) {
  long long ctas;
  int threads;
  const int err = gj_copy_bytes_grid(n, &ctas, &threads);
  if (err != 0) return err;
  if (ctas > 0)
    copy_bytes_kernel<<<(unsigned)ctas, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, (uint8_t*)dst, n);
  return (int)cudaGetLastError();
}
