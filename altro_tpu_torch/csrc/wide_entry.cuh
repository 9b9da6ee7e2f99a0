// The entry-per-thread Riccati tail of kernel B's entry body, its wide
// body's narrow end (riccati_fused.cu: fused_expand_backward_wide_entry,
// for the TPU kernel altro_tpu/ops/riccati_fused.py: fused_expand_backward
// at n + m <= kEntryWidth). Per knot, after the caller has formed the
// expansion in
// shared memory (Qxx's upper triangle in Vxx's place, Qx, Qux, Qu, Quu):
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
// At m = 2 this is 4 block barriers per knot and chains of a few dozen
// operations, which is why kernel B's narrow end keeps it; wide.cuh's
// blocked tail pays at a wide control (m = 64: here 2m barriers and n + 1
// serial chains of ~3m^2). Kernel D's wide body, first built on it, is on
// wide.cuh's tail, faster at every wide shape measured (PERF.md).
#pragma once

#include <cstddef>

#include "wide.cuh"

namespace altro {
namespace wide_entry {

using wide::pivot;
using wide::upper_ij;

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

}  // namespace wide_entry
}  // namespace altro
