// PTX helpers of the port's Hopper kernels: asynchronous global-to-shared
// copies (cp.async) and named barriers for a group of warps.
#pragma once

#include <cuda_runtime.h>

namespace altro {

// Copy one element from global to shared memory without going through
// registers (cp.async.ca, 4 or 8 bytes: one float or double). The copy lands
// after cp_async_wait_all() in the issuing thread; a barrier then shows it to
// the others.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 bytes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier over the `count` threads (whole warps) that name barrier `id`
// (1..15; 0 is __syncthreads), with the memory ordering of __syncthreads
// among them.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace altro
