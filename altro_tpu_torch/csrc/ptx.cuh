// PTX helpers of the port's Hopper kernels: asynchronous global-to-shared
// copies (cp.async, element-wise or 16 bytes at a time) and named barriers
// for a group of warps.
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

// Copy 16 bytes (both addresses 16-byte aligned) from global to shared
// memory, bypassing L1 (cp.async.cg): the rows a block streams once.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most `Pending` of the issuing thread's most recent commit
// groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Where a thread starts in a rows x cols copy (cols counted in copies) and
// how far it steps, for stage_rows: computed once per width, so that the
// copies themselves divide nothing.
struct Spread {
  int r, c, dr, dc;
  __device__ Spread() : r(0), c(0), dr(0), dc(0) {}
  __device__ Spread(int cols, int t, int nt)
      : r(cols > 0 ? t / cols : 0), c(cols > 0 ? t - (t / cols) * cols : 0),
        dr(cols > 0 ? nt / cols : 0),
        dc(cols > 0 ? nt - (nt / cols) * cols : 0) {}
};

// Stage rows x cols elements (row stride cols in src, ld in dst) by
// cp.async, neighbouring threads on neighbouring addresses: 16-byte copies
// when `vec` (cols a multiple of 16 / sizeof(T), src, dst and ld aligned to
// it; `sp` then spreads cols / (16 / sizeof(T)) copies per row), else one
// element per copy (`sp` spreads cols). Commits nothing.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int rows, int cols, bool vec,
                                           const Spread& sp) {
  const int v = vec ? 16 / (int)sizeof(T) : 1;
  const int cv = cols / v;
  int r = sp.r, c = sp.c;
  while (r < rows) {
    if (vec)
      cp_async16(dst + r * ld + c * v, src + (size_t)r * cols + c * v);
    else
      cp_async(dst + r * ld + c, src + (size_t)r * cols + c);
    r += sp.dr;
    c += sp.dc;
    if (c >= cv) {
      c -= cv;
      ++r;
    }
  }
}

// One row of cols elements, element-wise, element t by thread t (a thread
// index shifted by an offset spreads several rows over the block).
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int cols,
                                          int t) {
  if (t >= 0 && t < cols) cp_async(dst + t, src + t);
}

// Barrier over the `count` threads (whole warps) that name barrier `id`
// (1..15; 0 is __syncthreads), with the memory ordering of __syncthreads
// among them.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace altro
