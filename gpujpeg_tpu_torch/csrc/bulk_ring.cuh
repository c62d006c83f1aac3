// One-dimensional bulk copies from device memory into shared memory
// (`cp.async.bulk`, the TMA's 1-D form), completed on an mbarrier, for the
// shared rings of D2 (idct_rgb.cu) and D2p (idct_planes.cu).
//
// A ring buffer's barrier is initialised once for one arriving thread. Each
// use: that thread calls `bulk_expect` with the bytes of the whole fill,
// then `bulk_copy` for each piece (source, destination and size multiples
// of 16 bytes); the consumers call `bulk_wait` with the parity of the use
// (its count modulo 2, from 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// before the CTA's first bulk copy: one thread initialises each barrier,
// then every thread fences and the CTA synchronises
__device__ __forceinline__ void bulk_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the buffer was read by the CTA (ordered before this by a barrier): order
// those generic accesses before the async proxy's writes, then arm `bar`
// for `bytes`
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

}  // namespace
