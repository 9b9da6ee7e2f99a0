// The Riccati tail shared by the wide bodies of kernels B and D
// (riccati_fused.cu, riccati.cu): widths above kNarrowDim up to kMaxDim.
//
// One block of kWideThreads threads works one scenario, and every matrix
// lies in shared memory: a scenario's work space at n = m = 64 is ~25k
// elements (~200 KB in double), so one scenario fills what a block may use.
// The knot's problem rows are read from device memory, where every
// scenario's block finds the shared ones in L2. The block barrier
// (__syncthreads) orders the passes. Per knot, after the caller has formed
// the expansion (Qxx's upper triangle in Vxx's place, Qx, Qux, Qu, Quu):
//
//   factor   L L' = Quu + reg I, column by column: thread 0 the pivot
//            (clamped as sqrt(max(., 1e-12)), a NaN kept), the block the
//            column below it;
//   solve    n + 1 threads each solve one column of (K | d) = -(L L')^-1
//            (Qux | Qu) and form its column of Quu K (the d column: Quu d
//            and the dV sums, in that thread's registers across knots);
//   value    Vxx = Qxx + K'Quu K + K'Qux + Qux'K (upper triangle, mirrored)
//            and Vx = Qx + K'(Quu d + Qu) + Qux'd; K and d stored.
//
// What bounds the wide bodies on the H100: at n = m = 64, N = 21, B = 1024
// their FLOPs (kernel B: ~98 GFLOP, 1.5 ms at 67 TFLOP/s f32). What they
// reach is set by one block's knot chain: one or two scenarios per SM
// (the work space fills shared memory), 2m block barriers per knot in the
// factorization, and n + 1 threads of 256 in the solves; a simple body,
// its times in PERF.md.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace altro {
namespace wide {

constexpr int kWideThreads = 256;

// sqrt(max(x, 1e-12)) that keeps a NaN, as jnp.maximum does.
template <typename T>
__device__ __forceinline__ T pivot(T x) {
  return sqrt(x > T(1e-12) || x != x ? x : T(1e-12));
}

// (i, j) of entry e of the upper triangle of a w x w matrix, row by row.
__device__ __forceinline__ void upper_ij(int e, int w, int* i, int* j) {
  int r = 0;
  while (e >= w - r) {
    e -= w - r;
    ++r;
  }
  *i = r;
  *j = r + e;
}

// V A [n, n] and V B [n, m] from Vxx, with A [n, n] and B [n, m] in device
// memory.
template <typename T>
__device__ void vab(const T* Vxx, const T* A, const T* Bm, T* VA, T* VB,
                    int n, int m) {
  for (int e = threadIdx.x; e < n * n + n * m; e += blockDim.x) {
    const bool va = e < n * n;
    const int w = va ? n : m, ee = va ? e : e - n * n;
    const int i = ee / w, j = ee % w;
    const T* D = (va ? A : Bm) + j;
    T acc = T(0);
    for (int p = 0; p < n; ++p) acc += Vxx[i * n + p] * D[p * w];
    (va ? VA : VB)[ee] = acc;
  }
}

// Quu + reg I = L L' into Lc (row-major, lower triangle); ends on a barrier.
template <typename T>
__device__ void factor(const T* Quu, T* Lc, T regb, int m) {
  for (int j = 0; j < m; ++j) {
    if (threadIdx.x == 0) {
      T dg = Quu[j * m + j] + regb;
      for (int p = 0; p < j; ++p) dg -= Lc[j * m + p] * Lc[j * m + p];
      Lc[j * m + j] = pivot(dg);
    }
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) {
      T s = Quu[i * m + j];
      for (int p = 0; p < j; ++p) s -= Lc[i * m + p] * Lc[j * m + p];
      Lc[i * m + j] = s / Lc[j * m + j];
    }
    __syncthreads();
  }
}

// Column c = threadIdx.x <= n of (K | d), solved in place in KD[c * m ..];
// then its column of Quu K into QuuK [m, n], or for c = n Quu d into Quud
// and the dV sums into *dv1, *dv2.
template <typename T>
__device__ void solve(const T* Lc, const T* Quu, const T* Qux, const T* Qu,
                      T* KD, T* QuuK, T* Quud, int n, int m, T* dv1, T* dv2) {
  const int c = threadIdx.x;
  if (c > n) return;
  T* col = KD + c * m;
  for (int i = 0; i < m; ++i) {
    T s = c < n ? -Qux[i * n + c] : -Qu[i];
    for (int p = 0; p < i; ++p) s -= Lc[i * m + p] * col[p];
    col[i] = s / Lc[i * m + i];
  }
  for (int i = m - 1; i >= 0; --i) {
    T s = col[i];
    for (int p = i + 1; p < m; ++p) s -= Lc[p * m + i] * col[p];
    col[i] = s / Lc[i * m + i];
  }
  T s1 = T(0), s2 = T(0);
  for (int i = 0; i < m; ++i) {
    T acc = T(0);
    for (int p = 0; p < m; ++p) acc += Quu[i * m + p] * col[p];
    if (c < n) {
      QuuK[i * n + c] = acc;
    } else {
      Quud[i] = acc;
      s1 += col[i] * Qu[i];
      s2 += col[i] * acc;
    }
  }
  if (c == n) {
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

// Vxx and Vx in place of Qxx (upper triangle in Vxx) and beside Qx; at the
// terminal knot (term) V is the expansion itself.
template <typename T>
__device__ void value(T* Vxx, T* Vx, const T* Qx, const T* KD,
                      const T* QuuK, const T* Qux, const T* Quud,
                      const T* Qu, bool term, int n, int m) {
  const int n_tri = n * (n + 1) / 2;
  const T* dk = KD + n * m;
  for (int e = threadIdx.x; e < n_tri + n; e += blockDim.x) {
    if (e < n_tri) {
      int i, j;
      upper_ij(e, n, &i, &j);
      T s1 = T(0), s2 = T(0), s3 = T(0);
      if (!term) {
        for (int p = 0; p < m; ++p) {
          s1 += KD[i * m + p] * QuuK[p * n + j];
          s2 += KD[i * m + p] * Qux[p * n + j];
          s3 += KD[j * m + p] * Qux[p * n + i];
        }
      }
      const T v = Vxx[i * n + j] + s1 + s2 + s3;
      Vxx[i * n + j] = v;
      Vxx[j * n + i] = v;
    } else {
      const int i = e - n_tri;
      T s1 = T(0), s2 = T(0);
      if (!term) {
        for (int p = 0; p < m; ++p) {
          s1 += KD[i * m + p] * (Quud[p] + Qu[p]);
          s2 += Qux[p * n + i] * dk[p];
        }
      }
      Vx[i] = Qx[i] + s1 + s2;
    }
  }
}

// K [m, n] (row-major, from KD's columns) and d [m] of one knot.
template <typename T>
__device__ void store_gains(const T* KD, T* Kb, T* db, int n, int m) {
  for (int e = threadIdx.x; e < m * n + m; e += blockDim.x) {
    if (e < m * n)
      Kb[e] = KD[(e % n) * m + e / n];
    else
      db[e - m * n] = KD[n * m + (e - m * n)];
  }
}

// Ready a wide body for `bytes` of dynamic shared memory: opt in above
// 48 KB, refuse above what a block may use (227 KB). Returns a CUDA error
// code.
template <typename Kernel>
inline cudaError_t prepare(Kernel kern, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  if (bytes > 232448 - attr.sharedSizeBytes) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024 - attr.sharedSizeBytes)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

}  // namespace wide
}  // namespace altro
