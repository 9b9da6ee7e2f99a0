// AL expansion fused into the Riccati backward pass.
//
// Replaces the TPU kernel altro_tpu/ops/riccati_fused.py:
// fused_expand_backward (Pallas body `_make_kernel`), for ZERO, NONPOS and
// SOC constraint blocks. At every knot, from the terminal one backwards, it
// forms the quadratic expansion of the augmented Lagrangian from the SHARED
// cost, dynamics and constraint rows and the per-scenario x, u, lambda and
// rho:
//
//   z = lam + rho (Cx x + Cu u + b)
//   ZERO:   g = z mask,          w = rho mask
//   NONPOS: g = max(z, 0) mask,  w = rho [z > 0] mask
//   SOC, z = (v, s), a = |v|, a_safe = a > 0 ? a : 1:
//     polar = [a <= -s], bnd = [a > s and a > -s],
//     gamma = bnd (a - s) / (2 a_safe), vh = v / a_safe;
//     v rows: g = (polar + gamma) z mask, w = rho (polar + gamma) mask;
//     s row:  g = (polar s - gamma a) mask, w = rho polar mask;
//     plus the rank-1 curvature terms coef1 u1 u1' + coef2 u2 u2' with
//     u1 = (vh, 0), u2 = (-vh, 1), coef1 = -rho mask gamma,
//     coef2 = rho mask bnd / 2 (the exact polar-projection Jacobian)
//   lx = Q x + q + H'u + Cx'g,
//   lxx = Q + Cx' diag(w) Cx + sum_SOC coef (Cx'u1)(Cx'u1)'  (u, ux alike)
//
// and runs the Riccati recursion on it, with the regularised m x m Cholesky
// of Quu + reg I (pivots clamped as sqrt(max(., 1e-12))), writing
// K [Bt, N-1, m, n], d [Bt, N-1, m] and the expected-decrease terms
// dV1, dV2 [Bt]. The terminal knot is expanded with u = 0. The blocks
// arrive row-concatenated with a block table (common.cuh: BlockTable, one
// entry per block, its multipliers read where they lie); every block shares
// the first block's penalty rho, as on the TPU. Comparisons follow jnp's, so
// a NaN in a lane's inputs stays NaN in its outputs.
//
// Thread mapping: a group of TG threads (64, or 128 above 256 expansion
// entries) works one scenario; a block of 256 threads holds 256 / TG
// groups, and each group syncs on its own named barrier (bar.sync 1 + group,
// TG), so groups never wait for each other inside a knot. The TPU grid's
// sequential knot axis is a loop inside the block. Per knot:
//
//   staging  the knot's shared rows (Q q R r H A B Cx Cu b mask) once per
//            block and each scenario's x, u, lambda, rho, by cp.async into a
//            double buffer one knot ahead: knot k-1 loads while knot k
//            computes, and one __syncthreads per knot hands the buffers over;
//   pass 1   one constraint row per thread (z, g, w), and V A, V B with the
//            entries spread over the group; an SOC block then adds two
//            passes (one thread per block forms |v|, the case flags and the
//            rank-1 weights; then its rows' g, w and its projections Cx'u1,
//            Cx'u2, Cu'u1, Cu'u2);
//   pass 2   every expansion entry at once, one thread per entry: each thread
//            OWNS fixed entries of the upper triangle of Qxx and of Qx and
//            keeps them in registers until it turns them into its entries of
//            Vxx and Vx; the upper triangle of Quu, Qux and Qu go to shared
//            memory. The matrix entries share one loop body and Qx, Qu
//            another;
//   pass 3   the group's first warp factors Quu + reg I with row i in lane
//            i's registers (m <= 8: shuffles, no barrier, no pivot
//            synchronisation), then n + 1 threads each solve one column of
//            (K | d) in registers and form its column of Quu K (the d
//            thread: Quu d and both dV sums, in registers across knots).
//            Above m = 8 the first warp factors column by column in shared
//            memory instead;
//   pass 4   the owners form Vxx (upper triangle, mirrored) and Vx; K and d
//            are stored coalesced.
//
// Four group barriers per knot (six with SOC blocks) and one block barrier.
// Every m up to 8 (the register Cholesky's range) compiles as a constant in
// the groups of 64, so the factor, the solves and the loops over m unroll
// without guards; n stays a runtime width (a constant n as well gains far
// less than a constant m: PERF.md, kernel B's constant widths). The knot
// loop must stay small: unrolling each owned entry and each entry kind
// separately takes ~20k instructions per instantiation, and the warps then
// stall on instruction fetch.
//
// What bounds it on the H100: at B=1024, N=30, n=12, m=6, p=12 it moves
// ~13 MB (K 9 MB of it), 4 us at 3.35 TB/s, and does ~22 kFLOP per
// scenario-knot, 0.69 GFLOP or 10 us at 67 TFLOP/s f32: the FLOPs bound it.
// What it reaches is set by the knot chain: ~10 us per knot on the
// flagship (0.29 ms over 30 knots), with 8 groups (16 warps) per SM at 128
// registers, so B=1024 runs in one wave (PERF.md, kernel table).
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int kBlockThreads = 256;
// Groups of 64 threads take problems of up to 256 expansion entries (the
// upper triangles of Qxx and Quu, Qux, Qx, Qu), groups of 128 the rest.
constexpr int kSmallEntries = 256;

// Shared-memory sizes, in elements. One staging buffer: the knot rows
//   Q[n*n] q[n] R[m*m] r[m] H[m*n] A[n*n] B[n*m] Cx[P*n] Cu[P*m] b[P] mask[P]
// and per group x[n] u[m] lam[P] rho[1].
__host__ __device__ inline int knot_elems(int n, int m, int P) {
  return 2 * n * n + n + m * m + m + 2 * m * n + P * (n + m + 2);
}

__host__ __device__ inline int lane_elems(int n, int m, int P) {
  return n + m + P + 1;
}

// polar, gamma, a, a_safe, coef1, coef2, ax1[n], ax2[n], au1[m], au2[m]
constexpr int kSocScalars = 6;
__host__ __device__ inline int soc_elems(int n, int m) {
  return kSocScalars + 2 * (n + m);
}

// One group's work space: Vx[n] Vxx[n*n] z[P] g[P] w[P] Qu[m] Quu[m*m]
// Qux[m*n] Quud[m] Linv[m] VA[n*n] (the Cholesky factor Lc[m*m] in the
// same place, after V A's last use) VB[n*m] (later Quu K) KD[(n+1)*m], then
// per SOC block its scalars and projections.
__host__ __device__ inline int work_elems(int n, int m, int P, int nsoc) {
  const int va = n * n > m * m ? n * n : m * m;
  return n + n * n + 3 * P + m + m * m + m * n + 2 * m + va + n * m +
         (n + 1) * m + nsoc * soc_elems(n, m);
}

// Register-owned entries: the upper triangle of Qxx (row by row), then Qx.
__host__ __device__ inline int owned_entries(int n) {
  return n * (n + 1) / 2 + n;
}

// Shared entries: Qux (row-major), Qu, then the upper triangle of Quu.
__host__ __device__ inline int shared_entries(int m, int n) {
  return m * n + m + m * (m + 1) / 2;
}

template <typename T>
struct Knot {
  const T *Q, *q, *R, *r, *H, *A, *B, *Cx, *Cu, *b, *mask;
};

template <typename T>
struct Work {
  T *Vx, *Vxx, *z, *g, *w, *Qu, *Quu, *Qux, *Quud, *Linv, *VA, *VB, *KD, *soc;
};

// (i, j) of entry e of the upper triangle of an n x n matrix, row by row.
__device__ __forceinline__ void upper_ij(int e, int n, int* i, int* j) {
  int r = 0;
  while (e >= n - r) {
    e -= n - r;
    ++r;
  }
  *i = r;
  *j = r + e;
}

// z = lam + rho c and the per-row gradient g and curvature weight w of the
// ZERO and NONPOS rows, one row per thread.
template <typename T>
__device__ __forceinline__ void row_terms(const altro::BlockTable<T>& tab,
                                          const int8_t* row_blk,
                                          const Knot<T>& kn, const T* x,
                                          const T* u, const T* lam, T rho,
                                          bool with_u, int n, int m, int P,
                                          const Work<T>& wk, int t, int TG) {
  for (int rr = t; rr < P; rr += TG) {
    const int bi = row_blk[rr];
    T c = kn.b[rr];
#pragma unroll 4
    for (int i = 0; i < n; ++i) c += kn.Cx[rr * n + i] * x[i];
    if (with_u)
      for (int j = 0; j < m; ++j) c += kn.Cu[rr * m + j] * u[j];
    const T zr = lam[rr] + rho * c;
    wk.z[rr] = zr;
    const T mk = kn.mask[rr];
    if (tab.cone[bi] == altro::kNonpos) {
      const bool act = zr > T(0);
      // max(z, 0), NaN propagating like jnp.maximum
      wk.g[rr] = (act || zr != zr ? zr : T(0)) * mk;
      wk.w[rr] = rho * (act ? T(1) : T(0)) * mk;
    } else if (tab.cone[bi] == altro::kZero) {
      wk.g[rr] = zr * mk;
      wk.w[rr] = rho * mk;
    }
  }
}

// One thread per SOC block: |v|, the case flags and the rank-1 weights.
template <typename T>
__device__ __forceinline__ void soc_scalars(const altro::BlockTable<T>& tab,
                                            const Knot<T>& kn, T rho, int n,
                                            int m, const Work<T>& wk, int t,
                                            int TG) {
  const int se = soc_elems(n, m);
  for (int s = t; s < tab.nsoc; s += TG) {
    const int bi = tab.soc_block[s];
    const int r0 = tab.row0[bi], p = tab.p[bi];
    T a2 = T(0);
    for (int r = 0; r < p - 1; ++r) a2 += wk.z[r0 + r] * wk.z[r0 + r];
    const T sv = wk.z[r0 + p - 1];
    const T a = sqrt(a2);
    const T a_safe = a > T(0) ? a : T(1);
    // float flags multiplied in, as jnp does: a NaN z stays NaN
    const T polar = a <= -sv ? T(1) : T(0);
    const T bnd = (a > sv && a > -sv) ? T(1) : T(0);
    const T gamma = bnd * (a - sv) / (T(2) * a_safe);
    const T rm = rho * kn.mask[r0];
    T* sc = wk.soc + s * se;
    sc[0] = polar;
    sc[1] = gamma;
    sc[2] = a;
    sc[3] = a_safe;
    sc[4] = -(rm * gamma);
    sc[5] = T(0.5) * (rm * bnd);
  }
}

// The SOC rows' g and w, and each SOC block's projections ax1/ax2 = Cx'u1/u2
// (au = Cu'u, only when with_u), u1 = (vh, 0), u2 = (-vh, 1); one row or
// one projection entry per thread.
template <typename T>
__device__ __forceinline__ void soc_rows(const altro::BlockTable<T>& tab,
                                         const int8_t* row_blk,
                                         const Knot<T>& kn, T rho, bool with_u,
                                         int n, int m, int P, const Work<T>& wk,
                                         int t, int TG) {
  const int se = soc_elems(n, m);
  const int width = with_u ? n + m : n;
  const int total = P + tab.nsoc * width;
  for (int e = t; e < total; e += TG) {
    if (e < P) {
      const int rr = e, bi = row_blk[rr];
      if (tab.cone[bi] != altro::kSoc) continue;
      const T* sc = wk.soc + tab.slot[bi] * se;
      const T polar = sc[0], gamma = sc[1], mk = kn.mask[rr];
      const T zr = wk.z[rr];
      if (rr < tab.row0[bi] + tab.p[bi] - 1) {
        wk.g[rr] = (polar * zr + gamma * zr) * mk;
        wk.w[rr] = rho * (polar + gamma) * mk;
      } else {
        wk.g[rr] = (polar * zr - gamma * sc[2]) * mk;
        wk.w[rr] = rho * polar * mk;
      }
      continue;
    }
    const int s = (e - P) / width, i = (e - P) % width;
    const int bi = tab.soc_block[s];
    const int r0 = tab.row0[bi], p = tab.p[bi];
    T* sc = wk.soc + s * se;
    const T a_safe = sc[3];
    const bool state = i < n;
    const T* C = state ? kn.Cx + i : kn.Cu + (i - n);
    const int stride = state ? n : m;
    T acc1 = T(0), acc2 = T(0);
    for (int r = 0; r < p; ++r) {
      const T cr = C[(r0 + r) * stride];
      const T vh = r < p - 1 ? wk.z[r0 + r] / a_safe : T(0);
      acc1 += cr * vh;
      acc2 += cr * (r < p - 1 ? -vh : T(1));
    }
    if (state) {
      sc[kSocScalars + i] = acc1;
      sc[kSocScalars + n + i] = acc2;
    } else {
      sc[kSocScalars + 2 * n + (i - n)] = acc1;
      sc[kSocScalars + 2 * n + m + (i - n)] = acc2;
    }
  }
}

// sum over SOC blocks of coef1 p1_i q1_j + coef2 p2_i q2_j, where p and q
// are the blocks' projections at offsets oi and oj (0: Cx'u, 2n: Cu'u)
template <typename T>
__device__ __forceinline__ T rank_terms(const T* soc, int nsoc, int n, int m,
                                        int oi, int i, int oj, int j) {
  const int se = soc_elems(n, m);
  const int w2 = oi == 0 ? n : m, v2 = oj == 0 ? n : m;
  T acc = T(0);
  for (int s = 0; s < nsoc; ++s) {
    const T* sc = soc + s * se;
    const T* P1 = sc + kSocScalars + oi;
    const T* Q1 = sc + kSocScalars + oj;
    acc += (sc[4] * P1[i]) * Q1[j];
    acc += (sc[5] * P1[w2 + i]) * Q1[v2 + j];
  }
  return acc;
}

// Entry e of pass 2, in the order [Qxx upper | Qx | Qux | Qu | Quu upper]
// (the first owned_entries(n) stay in their thread's registers). The three
// matrix kinds share one loop body, and Qx, Qu another, with their operands
// picked by pointer and stride, so a warp that holds several kinds runs
// each body once and the knot loop stays small in the instruction cache.
// *d1, *d2: where a shared entry goes, as offsets from Qu (Qu, Quu and Qux
// lie in a row); the owned entries leave them unset. At the terminal knot
// only the owned entries are asked for, without the dynamics terms.
template <typename T>
__device__ __forceinline__ T expansion_entry(const Knot<T>& kn,
                                             const Work<T>& wk, const T* x,
                                             const T* u, bool term, int nsoc,
                                             int n, int m, int P, int e,
                                             int* d1, int* d2) {
  const int n_tri = n * (n + 1) / 2;
  int kind, i = 0, j = 0;  // 0 Qxx, 1 Qx, 2 Qux, 3 Qu, 4 Quu
  if (e < n_tri) {
    kind = 0;
    upper_ij(e, n, &i, &j);
  } else if ((e -= n_tri) < n) {
    kind = 1;
    i = e;
  } else if ((e -= n) < m * n) {
    kind = 2;
    i = e / n;
    j = e % n;
    *d1 = *d2 = m + m * m + e;
  } else if ((e -= m * n) < m) {
    kind = 3;
    i = e;
    *d1 = *d2 = i;
  } else {
    kind = 4;
    upper_ij(e - m, m, &i, &j);
    *d1 = m + i * m + j;
    *d2 = m + j * m + i;
  }
  if (kind == 1 || kind == 3) {
    // Qx = q + Q x + H'u + Cx'g + A'Vx;  Qu = r + R u + H x + Cu'g + B'Vx
    const bool xr = kind == 1;
    T acc = xr ? kn.q[i] : kn.r[i];
    const T* M1 = xr ? kn.Q + i * n : kn.R + i * m;
    const T* y1 = xr ? x : u;
    const int l1 = xr ? n : m;
#pragma unroll 4
    for (int p = 0; p < l1; ++p) acc += M1[p] * y1[p];
    if (!term) {
      const T* M2 = xr ? kn.H + i : kn.H + i * n;
      const T* y2 = xr ? u : x;
      const int a2 = xr ? n : 1, l2 = xr ? m : n;
#pragma unroll 4
      for (int p = 0; p < l2; ++p) acc += M2[p * a2] * y2[p];
    }
    const T* C = xr ? kn.Cx + i : kn.Cu + i;
    const int sc = xr ? n : m;
#pragma unroll 4
    for (int rr = 0; rr < P; ++rr) acc += C[rr * sc] * wk.g[rr];
    if (term) return acc;
    const T* D = xr ? kn.A + i : kn.B + i;
    const int sd = xr ? n : m;
    T dv = T(0);
#pragma unroll 4
    for (int p = 0; p < n; ++p) dv += D[p * sd] * wk.Vx[p];
    return acc + dv;
  }
  // Qxx = Q + Cx'W Cx + rank + A'V A;  Qux = H + Cu'W Cx + rank + B'V A;
  // Quu = R + Cu'W Cu + rank + B'V B
  const bool ui = kind != 0, uj = kind == 4;
  T acc = kind == 0 ? kn.Q[i * n + j] : kind == 2 ? kn.H[i * n + j]
                                                  : kn.R[i * m + j];
  const T* C1 = ui ? kn.Cu + i : kn.Cx + i;
  const T* C2 = uj ? kn.Cu + j : kn.Cx + j;
  const int s1 = ui ? m : n, s2 = uj ? m : n;
#pragma unroll 4
  for (int rr = 0; rr < P; ++rr)
    acc += (C1[rr * s1] * wk.w[rr]) * C2[rr * s2];
  acc += rank_terms(wk.soc, nsoc, n, m, ui ? 2 * n : 0, i, uj ? 2 * n : 0,
                    j);
  if (term) return acc;
  const T* D = ui ? kn.B + i : kn.A + i;
  const T* V = uj ? wk.VB + j : wk.VA + j;
  const int sd = ui ? m : n, sv = uj ? m : n;
  T dv = T(0);
#pragma unroll 4
  for (int p = 0; p < n; ++p) dv += D[p * sd] * V[p * sv];
  return acc + dv;
}

// Widest m factored in registers: lane i of the group's first warp holds
// row i of Quu + reg I.
constexpr int kRegM = 8;
constexpr unsigned kFull = 0xffffffffu;

// Quu + reg I = L L', factored by the group's first warp with row i in the
// registers of lane i (m <= kRegM): per column, one shuffle broadcasts the
// pivot and each later row's update takes that column's entries of the
// rows above by shuffles; no barrier. Summation order as column by column:
// entry (i, j) subtracts L(i, p) L(j, p) for p = 0, 1, ... L and the
// pivots' reciprocals go to Lc and Linv for the solves. Lanes past m
// factor a copy of row 0 and store nothing.
template <typename T>
__device__ __forceinline__ void factor_shfl(const Work<T>& wk, T* Lc, T* Linv,
                                            T regb, int m, int lane) {
  const int i = lane < m ? lane : 0;
  T a[kRegM];
#pragma unroll
  for (int j = 0; j < kRegM; ++j)
    a[j] = j < m ? wk.Quu[i * m + j] + (j == i ? regb : T(0)) : T(0);
  T inv = T(0);
#pragma unroll
  for (int j = 0; j < kRegM; ++j) {
    if (j < m) {
      const T d = sqrt(fmax(__shfl_sync(kFull, a[j], j), T(1e-12)));
      const T id = T(1) / d;
      if (lane == j) {
        a[j] = d;
        inv = id;
      } else if (lane > j) {
        a[j] *= id;
      }
#pragma unroll
      for (int k = j + 1; k < kRegM; ++k) {
        if (k < m) {
          const T lkj = __shfl_sync(kFull, a[j], k);
          if (lane >= k) a[k] -= a[j] * lkj;
        }
      }
    }
  }
  if (lane < m) {
#pragma unroll
    for (int j = 0; j < kRegM; ++j)
      if (j <= lane) Lc[lane * m + j] = a[j];
    Linv[lane] = inv;
  }
}

// Column c of (K | d) = -(L L')^-1 (Qux | Qu) in registers (m <= kRegM),
// with L and its pivots' reciprocals read from shared memory (one address
// for all the solving threads); then its column of Quu K, or, for the d
// column (c = n), Quu d and the dV sums.
template <typename T>
__device__ __forceinline__ void solve_column_regs(const Work<T>& wk,
                                                  const T* Lc, const T* Linv,
                                                  int n, int m, int c, T* dv1,
                                                  T* dv2) {
  T col[kRegM];
#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    if (i < m) {
      T s = c < n ? -wk.Qux[i * n + c] : -wk.Qu[i];
#pragma unroll
      for (int p = 0; p < i; ++p) s -= Lc[i * m + p] * col[p];
      col[i] = s * Linv[i];
    }
  }
#pragma unroll
  for (int i = kRegM - 1; i >= 0; --i) {
    if (i < m) {
      T s = col[i];
#pragma unroll
      for (int p = i + 1; p < kRegM; ++p)
        if (p < m) s -= Lc[p * m + i] * col[p];
      col[i] = s * Linv[i];
    }
  }
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    if (i < m) {
      wk.KD[c * m + i] = col[i];
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < kRegM; ++p)
        if (p < m) acc += wk.Quu[i * m + p] * col[p];
      if (c < n) {
        wk.VB[i * n + c] = acc;  // Quu K, in V B's place
      } else {
        wk.Quud[i] = acc;
        s1 += col[i] * wk.Qu[i];
        s2 += col[i] * acc;
      }
    }
  }
  if (c == n) {
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

// Above kRegM: the group's first warp factors Quu + reg I column by column
// into Lc (lane 0 the pivots); a group barrier follows.
template <typename T>
__device__ __forceinline__ void factor_warp(const Work<T>& wk, T* Lc, T regb,
                                            int m, int t) {
  if (t >= 32) return;
  for (int j = 0; j < m; ++j) {
    if (t == 0) {
      T dg = wk.Quu[j * m + j] + regb;
      for (int p = 0; p < j; ++p) dg -= Lc[j * m + p] * Lc[j * m + p];
      Lc[j * m + j] = sqrt(fmax(dg, T(1e-12)));
    }
    __syncwarp();
    for (int i = j + 1 + t; i < m; i += 32) {
      T s = wk.Quu[i * m + j];
      for (int p = 0; p < j; ++p) s -= Lc[i * m + p] * Lc[j * m + p];
      Lc[i * m + j] = s / Lc[j * m + j];
    }
    __syncwarp();
  }
}

// Column c of (K | d) from the shared factor Lc, solved in place in KD.
template <typename T>
__device__ __forceinline__ void solve_column_smem(const Work<T>& wk,
                                                  const T* Lc, int n, int m,
                                                  int c, T* dv1, T* dv2) {
  T* col = wk.KD + c * m;
  for (int i = 0; i < m; ++i) {
    T s = c < n ? -wk.Qux[i * n + c] : -wk.Qu[i];
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
    for (int p = 0; p < m; ++p) acc += wk.Quu[i * m + p] * col[p];
    if (c < n) {
      wk.VB[i * n + c] = acc;
    } else {
      wk.Quud[i] = acc;
      s1 += col[i] * wk.Qu[i];
      s2 += col[i] * acc;
    }
  }
  if (c == n) {
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

template <typename T, int TG, int MM>
__global__ void __launch_bounds__(kBlockThreads, 2)
fused_expand_backward_kernel(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ rho, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int N, int n, int m_arg, int P) {
  // MM > 0: the control width as a compile-time constant
  const int m = MM > 0 ? MM : m_arg;
  // entries owned per thread: at most kSmallEntries in a group of 64, the
  // upper triangle of Qxx and Qx at n = 32 in a group of 128
  constexpr int kOwn =
      TG == 64 ? kSmallEntries / 64 : (32 * 33 / 2 + 32 + TG - 1) / TG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  __shared__ int8_t row_blk[altro::kMaxRows];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int gpb = blockDim.x / TG;
  const int grp = threadIdx.x / TG;
  const int t = threadIdx.x % TG;
  const int bar = 1 + grp;
  const int b0 = blockIdx.x * gpb;
  const int b_raw = b0 + grp;
  const bool active = b_raw < Bt;
  const int b = active ? b_raw : Bt - 1;  // a spare group mirrors the last
  const int N1 = N - 1;

  if (threadIdx.x == 0) tab = table;
  for (int rr = threadIdx.x; rr < P; rr += blockDim.x) {
    int bi = 0;
    while (bi + 1 < table.count && rr >= table.row0[bi + 1]) ++bi;
    row_blk[rr] = (int8_t)bi;
  }
  __syncthreads();
  const int nsoc = tab.nsoc;

  const int ke = knot_elems(n, m, P);
  const int le = lane_elems(n, m, P);
  const int stage_elems = ke + gpb * le;
  T* bufs = smem;
  T* wbase = smem + 2 * stage_elems + grp * work_elems(n, m, P, nsoc);
  Work<T> wk;
  wk.Vx = wbase;
  wk.Vxx = wk.Vx + n;
  wk.z = wk.Vxx + n * n;
  wk.g = wk.z + P;
  wk.w = wk.g + P;
  wk.Qu = wk.w + P;
  wk.Quu = wk.Qu + m;
  wk.Qux = wk.Quu + m * m;
  wk.Quud = wk.Qux + m * n;
  wk.Linv = wk.Quud + m;
  wk.VA = wk.Linv + m;
  wk.VB = wk.VA + (n * n > m * m ? n * n : m * m);
  wk.KD = wk.VB + n * m;  // column c at KD[c*m]: K[:, c], d at c = n
  wk.soc = wk.KD + (n + 1) * m;
  T* Lc = wk.VA;  // the Cholesky factor, after V A's last use

  // knot k's rows and every group's lane inputs into dst
  auto stage = [&](int k, T* dst) {
    const bool term = k == N1;
    const int tid = threadIdx.x, nt = blockDim.x;
    auto rows = [&](int off, const T* src, int count) {
      for (int e = tid; e < count; e += nt)
        altro::cp_async(dst + off + e, src + e);
    };
    int off = 0;
    rows(off, Q + (size_t)k * n * n, n * n);
    off += n * n;
    rows(off, q + (size_t)k * n, n);
    off += n;
    if (!term) {
      rows(off, R + (size_t)k * m * m, m * m);
      rows(off + m * m, r + (size_t)k * m, m);
      rows(off + m * m + m, H + (size_t)k * m * n, m * n);
      rows(off + m * m + m + m * n, A + (size_t)k * n * n, n * n);
      rows(off + m * m + m + m * n + n * n, Bm + (size_t)k * n * m, n * m);
    }
    off += m * m + m + m * n + n * n + n * m;
    rows(off, Cx + (size_t)k * P * n, P * n);
    off += P * n;
    if (!term) rows(off, Cu + (size_t)k * P * m, P * m);
    off += P * m;
    rows(off, cb + (size_t)k * P, P);
    off += P;
    rows(off, cmask + (size_t)k * P, P);
    for (int e = tid; e < gpb * le; e += nt) {
      const int gi = e / le, j = e % le;
      const size_t bb = (size_t)min(b0 + gi, Bt - 1);
      const T* src;
      if (j < n) {
        src = X + (bb * N + k) * n + j;
      } else if (j < n + m) {
        if (term) continue;  // the terminal knot has no u
        src = U + (bb * N1 + k) * m + (j - n);
      } else if (j < n + m + P) {
        const int rr = j - n - m, bi = row_blk[rr];
        src = tab.lam[bi] + (bb * N + k) * tab.p[bi] + (rr - tab.row0[bi]);
      } else {
        src = rho + bb * N + k;
      }
      altro::cp_async(dst + ke + e, src);
    }
  };

  // the thread's owned entries of Qxx (upper triangle) and Qx: entries
  // t + s TG (s < kOwn) of pass 2, kept in registers from pass 2 to pass 4
  const int n_own = owned_entries(n);
  const int n_tri = n * (n + 1) / 2;
  T own_q[kOwn];
#pragma unroll
  for (int s = 0; s < kOwn; ++s) own_q[s] = T(0);
  const int n_shared = shared_entries(m, n);
  const T regb = reg[b];
  T dv1 = T(0), dv2 = T(0);

  stage(N1, bufs + (N1 & 1) * stage_elems);
  altro::cp_async_commit();
  for (int k = N1; k >= 0; --k) {
    // knot k has landed, and every group is past knot k+1, whose buffer
    // the prefetch of knot k-1 now takes
    altro::cp_async_wait_all();
    __syncthreads();
    if (k > 0) {
      stage(k - 1, bufs + ((k - 1) & 1) * stage_elems);
      altro::cp_async_commit();
    }
    const bool term = k == N1;
    const T* cur = bufs + (k & 1) * stage_elems;
    Knot<T> kn;
    kn.Q = cur;
    kn.q = kn.Q + n * n;
    kn.R = kn.q + n;
    kn.r = kn.R + m * m;
    kn.H = kn.r + m;
    kn.A = kn.H + m * n;
    kn.B = kn.A + n * n;
    kn.Cx = kn.B + n * m;
    kn.Cu = kn.Cx + P * n;
    kn.b = kn.Cu + P * m;
    kn.mask = kn.b + P;
    const T* x = cur + ke + grp * le;
    const T* u = x + n;
    const T* lam = u + m;
    const T rk = lam[P];

    // pass 1: the rows' z, g, w; V A and V B
    row_terms(tab, row_blk, kn, x, u, lam, rk, !term, n, m, P, wk, t, TG);
    if (!term) {
      // V A [n, n] and V B [n, m]: one loop body, the operand by stride
      for (int e = t; e < n * n + n * m; e += TG) {
        const bool va = e < n * n;
        const int w = va ? n : m, ee = va ? e : e - n * n;
        const int i = ee / w, j = ee % w;
        const T* D = (va ? kn.A : kn.B) + j;
        T acc = T(0);
#pragma unroll 4
        for (int p = 0; p < n; ++p) acc += wk.Vxx[i * n + p] * D[p * w];
        (va ? wk.VA : wk.VB)[ee] = acc;
      }
    }
    altro::group_sync(bar, TG);
    if (nsoc) {
      soc_scalars(tab, kn, rk, n, m, wk, t, TG);
      altro::group_sync(bar, TG);
      soc_rows(tab, row_blk, kn, rk, !term, n, m, P, wk, t, TG);
      altro::group_sync(bar, TG);
    }

    // pass 2: every expansion entry at once; slot s of thread t is entry
    // t + s TG, and the owned ones stay in own_q[s]
    const int n_all = term ? n_own : n_own + n_shared;
#pragma unroll 1
    for (int s = 0; t + s * TG < n_all; ++s) {
      const int e = t + s * TG;
      int d1 = 0, d2 = 0;
      const T v = expansion_entry(kn, wk, x, u, term, nsoc, n, m, P, e, &d1,
                                  &d2);
      if (e < n_own) {
#pragma unroll
        for (int q = 0; q < kOwn; ++q)
          if (q == s) own_q[q] = v;
      } else {
        wk.Qu[d1] = v;
        wk.Qu[d2] = v;
      }
    }
    if (!term) {
      altro::group_sync(bar, TG);
      // pass 3: (K | d), Quu K, Quu d, dV
      if (m <= kRegM) {
        if (n < 32) {
          // the factor and the n + 1 solves all sit in the first warp
          if (t < 32) {
            factor_shfl(wk, Lc, wk.Linv, regb, m, t);
            __syncwarp();
            if (t <= n)
              solve_column_regs(wk, Lc, wk.Linv, n, m, t, &dv1, &dv2);
          }
        } else {
          if (t < 32) factor_shfl(wk, Lc, wk.Linv, regb, m, t);
          altro::group_sync(bar, TG);
          if (t <= n)
            solve_column_regs(wk, Lc, wk.Linv, n, m, t, &dv1, &dv2);
        }
      } else {
        factor_warp(wk, Lc, regb, m, t);
        altro::group_sync(bar, TG);
        if (t <= n) solve_column_smem(wk, Lc, n, m, t, &dv1, &dv2);
      }
      altro::group_sync(bar, TG);
    }

    // pass 4: V from the owned Q entries (at the terminal knot V is the
    // expansion itself); K and d stored coalesced
    const T* QuuK = wk.VB;
    const T* dk = wk.KD + n * m;
#pragma unroll 1
    for (int s = 0; s < kOwn && t + s * TG < n_own; ++s) {
      const int e = t + s * TG;
      T q = T(0);
#pragma unroll
      for (int qq = 0; qq < kOwn; ++qq)
        if (qq == s) q = own_q[qq];
      if (e < n_tri) {
        // Vxx = Qxx + K'Quu K + K'Qux + Qux'K, upper triangle mirrored
        int i, j;
        upper_ij(e, n, &i, &j);
        T s1 = T(0), s2 = T(0), s3 = T(0);
        if (!term) {
          for (int p = 0; p < m; ++p) {
            s1 += wk.KD[i * m + p] * QuuK[p * n + j];
            s2 += wk.KD[i * m + p] * wk.Qux[p * n + j];
            s3 += wk.KD[j * m + p] * wk.Qux[p * n + i];
          }
        }
        const T v = q + s1 + s2 + s3;
        wk.Vxx[i * n + j] = v;
        wk.Vxx[j * n + i] = v;
      } else {
        // Vx = Qx + K'(Quu d + Qu) + Qux' d
        const int i = e - n_tri;
        T s1 = T(0), s2 = T(0);
        if (!term) {
          for (int p = 0; p < m; ++p) {
            s1 += wk.KD[i * m + p] * (wk.Quud[p] + wk.Qu[p]);
            s2 += wk.Qux[p * n + i] * dk[p];
          }
        }
        wk.Vx[i] = q + s1 + s2;
      }
    }
    if (term) continue;
    if (active) {
      T* Kb = Kout + ((size_t)b * N1 + k) * m * n;
      T* db = dout + ((size_t)b * N1 + k) * m;
      for (int e = t; e < m * n + m; e += TG) {
        if (e < m * n)
          Kb[e] = wk.KD[(e % n) * m + e / n];
        else
          db[e - m * n] = dk[e - m * n];
      }
    }
  }

  if (active && t == n) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
}

template <typename T, int TG, int MM>
int launch_group(const void* Q, const void* q, const void* R, const void* r,
                 const void* H, const void* A, const void* Bm,
                 const void* Cx, const void* Cu, const void* cb,
                 const void* cmask, const altro::BlockTable<T>& table,
                 const void* X, const void* U, const void* rho,
                 const void* reg, void* K, void* d, void* dV1, void* dV2,
                 int Bt, int N, int n, int m, int P, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, fused_expand_backward_kernel<T, TG, MM>);
  if (e != cudaSuccess) return (int)e;
  const size_t cap = 232448 - attr.sharedSizeBytes;  // 227 KB opt-in limit
  // groups per block: 256 threads, halved until the work spaces fit
  int gpb = kBlockThreads / TG;
  size_t bytes = 0;
  for (;;) {
    bytes = (size_t)(2 * (knot_elems(n, m, P) + gpb * lane_elems(n, m, P)) +
                     gpb * work_elems(n, m, P, table.nsoc)) *
            sizeof(T);
    if (bytes <= cap || gpb == 1) break;
    gpb /= 2;
  }
  if (bytes > cap) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024 - attr.sharedSizeBytes) {
    e = cudaFuncSetAttribute(fused_expand_backward_kernel<T, TG, MM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((Bt + gpb - 1) / gpb);
  fused_expand_backward_kernel<T, TG, MM>
      <<<blocks, gpb * TG, bytes, stream>>>(
          (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,
          (const T*)A, (const T*)Bm, (const T*)Cx, (const T*)Cu,
          (const T*)cb, (const T*)cmask, table, (const T*)X, (const T*)U,
          (const T*)rho, (const T*)reg, (T*)K, (T*)d, (T*)dV1, (T*)dV2, Bt,
          N, n, m, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* Q, const void* q, const void* R, const void* r,
                 const void* H, const void* A, const void* Bm,
                 const void* Cx, const void* Cu, const void* cb,
                 const void* cmask, int nblocks, const int* meta,
                 const void* const* lams, const void* X, const void* U,
                 const void* rho, const void* reg, void* K, void* d,
                 void* dV1, void* dV2, int Bt, int N, int n, int m, int P,
                 void* stream) {
  if (n < 1 || m < 1 || n > altro::kMaxDim || m > altro::kMaxDim || P < 0 ||
      P > altro::kMaxRows || N < 2 || Bt < 1)
    return (int)cudaErrorInvalidValue;
  altro::BlockTable<T> table;
  if (!altro::make_table(nblocks, meta, lams, P, &table))
    return (int)cudaErrorInvalidValue;
  // 64 threads per scenario up to kSmallEntries expansion entries (the
  // flagship's 189: at 128 registers 8 groups of 2 warps fit an SM, so
  // B=1024 runs in one wave), 128 above
  const int entries = owned_entries(n) + shared_entries(m, n);
  cudaStream_t s = (cudaStream_t)stream;
  // in groups of 64, every m <= kRegM compiles as a constant; wider m and
  // the groups of 128 take the generic instantiations
#define ALTRO_FUSED_LAUNCH(TG, MM)                                          \
  launch_group<T, TG, MM>(Q, q, R, r, H, A, Bm, Cx, Cu, cb, cmask, table,   \
                          X, U, rho, reg, K, d, dV1, dV2, Bt, N, n, m, P, s)
  if (entries > kSmallEntries) return ALTRO_FUSED_LAUNCH(128, 0);
  static_assert(kRegM == 8, "one constant-m instantiation per m <= kRegM");
  switch (m) {
    case 1: return ALTRO_FUSED_LAUNCH(64, 1);
    case 2: return ALTRO_FUSED_LAUNCH(64, 2);
    case 3: return ALTRO_FUSED_LAUNCH(64, 3);
    case 4: return ALTRO_FUSED_LAUNCH(64, 4);
    case 5: return ALTRO_FUSED_LAUNCH(64, 5);
    case 6: return ALTRO_FUSED_LAUNCH(64, 6);
    case 7: return ALTRO_FUSED_LAUNCH(64, 7);
    case 8: return ALTRO_FUSED_LAUNCH(64, 8);
    default: return ALTRO_FUSED_LAUNCH(64, 0);
  }
#undef ALTRO_FUSED_LAUNCH
}

}  // namespace

#define ALTRO_FUSED_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                      \
      const void* Q, const void* q, const void* R, const void* r,           \
      const void* H, const void* A, const void* Bm, const void* Cx,         \
      const void* Cu, const void* cb, const void* cmask, int nblocks,       \
      const int* meta, const void* const* lams, const void* X,              \
      const void* U, const void* rho, const void* reg, void* K, void* d,    \
      void* dV1, void* dV2, int Bt, int N, int n, int m, int P,             \
      void* stream) {                                                       \
    return launch_fused<T>(Q, q, R, r, H, A, Bm, Cx, Cu, cb, cmask,         \
                           nblocks, meta, lams, X, U, rho, reg, K, d, dV1,  \
                           dV2, Bt, N, n, m, P, stream);                    \
  }

ALTRO_FUSED_ENTRY(altro_fused_expand_backward_f32, float)
ALTRO_FUSED_ENTRY(altro_fused_expand_backward_f64, double)
