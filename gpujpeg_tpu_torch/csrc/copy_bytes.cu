// copy_bytes: dst[i] = src[i] for n bytes, the card's copy rate at frame
// size.
//
// Replaces the "null" copy kernel of `scripts/perf_stage1.py` (`nullk`
// under `run`, the identity on (N/2, 128) u8 tiles), which measured the
// TPU's per-grid-step cost and copy floor. Its TPU tile sweep has no
// counterpart: the grid here strides over the whole buffer.
//
// What bounds it: bytes, 2n over the memory rate (199 MB at 8K, 0.059 ms
// at 3.35 TB/s). Each thread moves 16-byte vectors, four loads in flight
// before their stores, in a grid-stride loop; when either pointer is not
// 16-byte aligned, or for the ragged tail past the last whole vector, it
// moves single bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  long long n) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long n16 = n >> 4;
    long long i = tid;
    for (; i + 3 * stride < n16; i += 4 * stride) {
      const uint4 a = s[i], b = s[i + stride], c = s[i + 2 * stride],
                  e = s[i + 3 * stride];
      d[i] = a;
      d[i + stride] = b;
      d[i + 2 * stride] = c;
      d[i + 3 * stride] = e;
    }
    for (; i < n16; i += stride) d[i] = s[i];
    done = n16 << 4;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" int gj_copy_bytes(const void* src, void* dst, long long n,
                             void* stream) {
  long long ctas = (n / 16 + kThreads - 1) / kThreads;
  if (ctas > 132 * 8) ctas = 132 * 8;  // 8 CTAs of 256 threads per SM
  if (ctas < 1) ctas = 1;
  if (n > 0)
    copy_bytes_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, (uint8_t*)dst, n);
  return (int)cudaGetLastError();
}
