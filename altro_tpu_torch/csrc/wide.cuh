// The blocked Riccati tail of the tiled wide bodies of kernel B
// (riccati_fused.cu: fused_expand_backward_wide, which replaces the TPU
// kernel altro_tpu/ops/riccati_fused.py: fused_expand_backward above
// n + m = kEntryWidth) and kernel D (riccati.cu: riccati_wide, for
// altro_tpu/ops/riccati.py: batched_riccati), the block-wide tiled
// products they are built from, and the helpers every wide body shares
// (pivot, upper_ij, prepare). The entry-per-thread tail of kernel B's
// narrow end is wide_entry.cuh.
//
// One block works one scenario with its work space in shared memory. Per
// knot, after the caller has formed the expansion, the tail takes it in
// this layout (Tail below; strides padded to 4
// elements, so that a thread reads 4 neighbouring elements of a row as one
// or two 16-byte loads):
//
//   Vq   [n x ldn]  Qxx's upper triangle in, Vxx (full, symmetric) out;
//   Qux  [m x ldn], Qu [m], Qx [n];
//   aug  [m x lda]  columns 0..m-1: Quu + reg I in the upper triangle and
//                   Quu in the strict lower one (its diagonal in qdiag);
//                   columns ma..ma+n: the right-hand sides -(Qux | Qu);
//   QuuK [m x ldk]  scratch: Quu K, and Quu d in column n.
//
//   factor_solve  a right-looking blocked Cholesky of the upper triangle,
//                 Quu + reg I = U'U, on the augmented rows, so that the
//                 forward substitution of the n + 1 right-hand sides rides
//                 along: per panel of kPanel rows, the first warp factors
//                 the diagonal block with row i in lane i's registers (pivots
//                 clamped as sqrt(max(., 1e-12)), a NaN kept), one thread
//                 per column solves the panel's rows to its right (kPanel
//                 steps), and the block updates every row below it as a
//                 tiled product; then the back substitution U (K | d) = Y,
//                 panel by panel from the last (whose forward and back
//                 steps one thread per right-hand side takes in one go),
//                 one thread per right-hand side inside the panel and a
//                 tiled update of the rows above. No thread runs a chain
//                 longer than 2 kPanel^2 operations.
//   quu_k         Quu (K | d) as a tiled product with the unregularised Quu
//                 (read from the strict lower triangle and qdiag);
//   value         Vxx = Qxx + K'Quu K + K'Qux + Qux'K as a tiled product over
//                 the upper triangle, mirrored; Vx = Qx + K'(Quu d + Qu) +
//                 Qux'd; dV1 += d'Qu, dV2 += d'Quu d / 2.
//
// Every tiled product gives each thread 4 x 4 outputs; per step of the
// inner dimension it reads one 4-vector of each operand from shared memory
// and does 16 FMAs. What bounds the tail on the H100 is its barriers: three
// per panel forward and two back, 38 per knot at m = 64 (2 at m = 2, 4
// with Quu K and V), each behind a short chain of dependent shared-memory
// loads; the FLOPs (~1.9 m^2 n + m^3 / 3 per knot) come second. The tail's
// functions are not inlined: each gets its own registers. Times in
// PERF.md. kWideThreads is the block of kernel B's entry-per-thread body
// (its narrow end).
#pragma once

#include <cstddef>

#include "common.cuh"

namespace altro {
namespace wide {

constexpr int kWideThreads = 256;
constexpr int kPanel = 8;  // rows of a Cholesky panel
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

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

// Four neighbouring elements from 16-byte aligned shared memory.
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* r) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    r[0] = a.x;
    r[1] = a.y;
    r[2] = b.x;
    r[3] = b.y;
  }
}

// acc[r][c] += a[r] b[c]
template <typename T>
__device__ __forceinline__ void outer4(T (&acc)[4][4], const T* a,
                                       const T* b) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
}

template <typename T>
__device__ __forceinline__ void zero4(T (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
}

// Strides of the tail's operands (see the note above).
struct TailDims {
  int ldn, ldk, ma, lda;
  __host__ __device__ TailDims(int n, int m)
      : ldn(pad4(n)), ldk(pad4(n + 1)), ma(pad4(m)), lda(pad4(m) + pad4(n + 1)) {}
};

template <typename T>
struct Tail {
  T* Vq;
  T* Qx;
  T* Vx;
  T* Qux;
  T* Qu;
  T* aug;
  T* qdiag;
  T* inv;
  T* QuuK;
  int n, m, ldn, ldk, ma, lda;
};

// The diagonal block (bb <= kPanel rows at D, upper triangle, row stride
// lda) factored by one warp: lane i holds row i of the symmetric block in
// registers; per column one shuffle broadcasts the pivot and each later
// row's update takes that column's entries by shuffles. Row i of L goes to
// column i of U (D[j][i] = L[i][j]), the pivots' reciprocals to inv.
template <typename T>
__device__ __forceinline__ void factor_block(T* D, T* inv, int lda, int bb,
                                             int lane) {
  const int i = lane < bb ? lane : 0;
  T a[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    a[j] = j < bb ? (j >= i ? D[i * lda + j] : D[j * lda + i]) : T(0);
  T iv = T(0);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (j < bb) {
      const T d = pivot(__shfl_sync(kFullMask, a[j], j));
      const T id = T(1) / d;
      if (lane == j) {
        a[j] = d;
        iv = id;
      } else if (lane > j) {
        a[j] *= id;
      }
#pragma unroll
      for (int k = j + 1; k < kPanel; ++k) {
        if (k < bb) {
          const T lkj = __shfl_sync(kFullMask, a[j], k);
          if (lane >= k) a[k] -= a[j] * lkj;
        }
      }
    }
  }
  if (lane < bb) {
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j <= lane) D[j * lda + lane] = a[j];
    inv[lane] = iv;
  }
}

// Quu + reg I = U'U and (K | d) = -(U'U)^-1 (Qux | Qu), in place in aug;
// ends on a barrier.
template <typename T>
__device__ __noinline__ void factor_solve(const Tail<T> tl) {
  const int n = tl.n, m = tl.m, lda = tl.lda, ma = tl.ma;
  const int t = threadIdx.x, nt = blockDim.x, nr = n + 1;
  const int nct = tl.ldk / 4;  // column tiles of the right-hand sides
  T* S = tl.aug;
  for (int j0 = 0; j0 < m; j0 += kPanel) {
    const int bb = min(kPanel, m - j0), r1 = j0 + bb;
    if (t < 32) factor_block(S + j0 * lda + j0, tl.inv + j0, lda, bb, t);
    __syncthreads();
    // the panel's rows right of the block: U_JK = U_JJ'^-1 S_JK, one
    // column per thread; in the last panel a right-hand side's thread goes
    // on to its back substitution there (U_JJ X_J = Y_J)
    const int right = m - r1;
    for (int e = t; e < right + nr; e += nt) {
      const int c = e < right ? r1 + e : ma + (e - right);
      T y[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        if (j < bb) {
          T s = S[(j0 + j) * lda + c];
#pragma unroll
          for (int p = 0; p < j; ++p) s -= S[(j0 + p) * lda + j0 + j] * y[p];
          y[j] = s * tl.inv[j0 + j];
          if (right > 0) S[(j0 + j) * lda + c] = y[j];
        }
      }
      if (right > 0) continue;
#pragma unroll
      for (int jj = kPanel - 1; jj >= 0; --jj) {
        if (jj < bb) {
          T s = y[jj];
#pragma unroll
          for (int p = jj + 1; p < kPanel; ++p)
            if (p < bb) s -= S[(j0 + jj) * lda + j0 + p] * y[p];
          y[jj] = s * tl.inv[j0 + jj];
          S[(j0 + jj) * lda + c] = y[jj];
        }
      }
    }
    __syncthreads();
    if (right == 0) break;
    // the rows below: S_IK -= U_JI' U_JK over the upper triangle and the
    // right-hand sides, 4 x 4 tiles (r1 is a multiple of kPanel here)
    const int I0 = r1 / 4, nI = (m + 3) / 4 - I0;
    const int ntri = nI * (nI + 1) / 2;
    for (int q = t; q < ntri + nI * nct; q += nt) {
      int I, J;
      const bool tri = q < ntri;
      if (tri) {
        upper_ij(q, nI, &I, &J);
        J = (I0 + J) * 4;
      } else {
        I = (q - ntri) / nct;
        J = ma + ((q - ntri) % nct) * 4;
      }
      const int i0 = (I0 + I) * 4;
      T acc[4][4];
      zero4(acc);
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
        T a[4], b[4];
        ld4(S + (j0 + p) * lda + i0, a);
        ld4(S + (j0 + p) * lda + J, b);
        outer4(acc, a, b);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= m) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = J + c;
          // the strict lower triangle holds Quu: leave it
          if (!tri || (col >= i && col < m)) S[i * lda + col] -= acc[r][c];
        }
      }
    }
    __syncthreads();
  }
  // back substitution U X = Y, panel by panel from the last (whose own
  // part is done)
  const int last = (m - 1) / kPanel * kPanel;
  for (int j0 = last; j0 >= 0; j0 -= kPanel) {
    const int bb = min(kPanel, m - j0);
    if (j0 != last) {
      for (int c = t; c < nr; c += nt) {
        T x[kPanel];
#pragma unroll
        for (int jj = kPanel - 1; jj >= 0; --jj) {
          if (jj < bb) {
            T s = S[(j0 + jj) * lda + ma + c];
#pragma unroll
            for (int p = jj + 1; p < kPanel; ++p)
              if (p < bb) s -= S[(j0 + jj) * lda + j0 + p] * x[p];
            x[jj] = s * tl.inv[j0 + jj];
            S[(j0 + jj) * lda + ma + c] = x[jj];
          }
        }
      }
      __syncthreads();
    }
    if (j0 == 0) break;
    // the rows above: Y_I -= U_IJ X_J, 4 x 4 tiles (j0 is a multiple of 4)
    const int nI = j0 / 4;
    for (int q = t; q < nI * nct; q += nt) {
      const int i0 = (q / nct) * 4, c0 = ma + (q % nct) * 4;
      T acc[4][4];
      zero4(acc);
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
        if (p < bb) {
          T a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = S[(i0 + r) * lda + j0 + p];
          ld4(S + (j0 + p) * lda + c0, b);
          outer4(acc, a, b);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) S[(i0 + r) * lda + c0 + c] -= acc[r][c];
    }
    __syncthreads();
  }
}

// Quu (K | d) into QuuK (Quu d in column n), with the unregularised Quu
// from aug's strict lower triangle and qdiag; a barrier must follow.
template <typename T>
__device__ __noinline__ void quu_k(const Tail<T> tl) {
  const int m = tl.m, lda = tl.lda, nct = tl.ldk / 4;
  const T* S = tl.aug;
  const int nI = (m + 3) / 4;
  for (int q = threadIdx.x; q < nI * nct; q += blockDim.x) {
    const int i0 = (q / nct) * 4, c0 = (q % nct) * 4;
    T acc[4][4];
    zero4(acc);
    for (int p = 0; p < m; ++p) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = min(i0 + r, m - 1);
        a[r] = i > p ? S[i * lda + p] : i < p ? S[p * lda + i] : tl.qdiag[i];
      }
      ld4(S + p * lda + tl.ma + c0, b);
      outer4(acc, a, b);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r >= m) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) tl.QuuK[(i0 + r) * tl.ldk + c0 + c] = acc[r][c];
    }
  }
}

// Vxx and Vx in place of Qxx (Vq's upper triangle) and beside Qx, and the
// dV sums (on thread 0, in its registers across knots); at the terminal
// knot (term) V is the expansion itself. Reads aug's K and d and QuuK
// (after a barrier that follows quu_k).
template <typename T>
__device__ __noinline__ void value(const Tail<T> tl, bool term, T* dv1, T* dv2) {
  const int n = tl.n, m = tl.m, ldn = tl.ldn, lda = tl.lda, ldk = tl.ldk;
  const T* Kd = tl.aug + tl.ma;  // K[p][i] at Kd[p * lda + i], d at i = n
  const int T4 = (n + 3) / 4;
  for (int q = threadIdx.x; q < T4 * (T4 + 1) / 2; q += blockDim.x) {
    int I, J;
    upper_ij(q, T4, &I, &J);
    const int i0 = 4 * I, j0 = 4 * J;
    T acc[4][4];
    zero4(acc);
    if (!term) {
      for (int p = 0; p < m; ++p) {
        T ki[4], xi[4], qj[4], xj[4], kj[4];
        ld4(Kd + p * lda + i0, ki);
        ld4(tl.Qux + p * ldn + i0, xi);
        ld4(tl.QuuK + p * ldk + j0, qj);
        ld4(tl.Qux + p * ldn + j0, xj);
        ld4(Kd + p * lda + j0, kj);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] += ki[r] * qj[c] + ki[r] * xj[c] + xi[r] * kj[c];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (i <= j && j < n) {
          const T v = tl.Vq[i * ldn + j] + acc[r][c];
          tl.Vq[i * ldn + j] = v;
          tl.Vq[j * ldn + i] = v;
        }
      }
    }
  }
  // Vx by the last threads, the dV sums by thread 0
  const int i = blockDim.x - 1 - threadIdx.x;
  if (i < n) {
    T s1 = T(0), s2 = T(0);
    if (!term) {
      for (int p = 0; p < m; ++p) {
        s1 += Kd[p * lda + i] * (tl.QuuK[p * ldk + n] + tl.Qu[p]);
        s2 += tl.Qux[p * ldn + i] * Kd[p * lda + n];
      }
    }
    tl.Vx[i] = tl.Qx[i] + s1 + s2;
  }
  if (!term && threadIdx.x == 0) {
    T s1 = T(0), s2 = T(0);
    for (int p = 0; p < m; ++p) {
      const T dp = Kd[p * lda + n];
      s1 += dp * tl.Qu[p];
      s2 += dp * tl.QuuK[p * ldk + n];
    }
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

// K [m, n] (row-major) and d [m] of one knot, from aug.
template <typename T>
__device__ __noinline__ void store_gains(const Tail<T> tl, T* Kb, T* db) {
  const int n = tl.n, m = tl.m;
  for (int e = threadIdx.x; e < m * n + m; e += blockDim.x) {
    if (e < m * n)
      Kb[e] = tl.aug[(e / n) * tl.lda + tl.ma + e % n];
    else
      db[e - m * n] = tl.aug[(e - m * n) * tl.lda + tl.ma + n];
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
