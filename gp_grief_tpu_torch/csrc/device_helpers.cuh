// Device helpers shared by the kernels: the FMA of every per-element chain,
// and the cp.async copies from global to shared memory.
//
// The clobbers: a wait carries "memory", since after it a thread reads what
// its copies wrote, so the compiler may neither move a shared-memory load
// above it nor keep a value read before it.  Copies and commits carry none,
// so the compiler may schedule the reads of the stage being summed across
// the next stage's copies.  That needs every kernel to put __syncthreads()
// (which no memory access crosses) between the last reads of a buffer and
// the next copies into it, as each kernel here does.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// acc + a * b rounded once, in T.
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// One copy of BYTES (16, 8 or 4) from global to shared memory.  The bytes
// past `src_bytes` are filled with zeros; src_bytes = 0 reads nothing.
// BYTES is a compile-time argument: a caller with a run-time size branches
// on it once, and no copy loop pays for sizes it never uses (a three-way
// run-time branch made the wide Kronecker member 5-10% slower).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

// The same copy under an L2 cache policy (createpolicy).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes, uint64_t pol) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes), "l"(pol));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2, %3;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes), "l"(pol));
  else
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes), "l"(pol));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
