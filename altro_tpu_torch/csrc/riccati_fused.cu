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
// The dynamics rows may also come per group of scenarios (A, B [G, N-1,
// ...], Bt / G contiguous scenarios to a group: the quadruped's contact
// schedules, which the JAX package batches by a vmap over schedules around
// a vmap over their lanes). grid.y then runs over the groups and a block's
// scenarios all lie in one group, so the block still stages each knot's
// rows once for all its scenarios; G = 1 is the shared case.
//
// Thread mapping: a group of TG threads works one scenario: 64, or 128
// above 256 expansion entries, except above m = 8 (up to 16), where the
// groups stay at 64 while a thread's owned entries fit its 4 register
// slots (n <= 21: the trot's 324 entries, 90 of them owned; fused_body
// holds the rule); a block of 256 threads holds 256 / TG
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
//            i's registers (m <= 8, and m <= 16 in the narrow body above
//            it: shuffles, no barrier, no pivot synchronisation), then
//            n + 1 threads each solve one column of (K | d) in registers
//            and form its column of Quu K (the d thread: Quu d and both dV
//            sums, in registers across knots). Wider m (m > 16, or m > 8
//            in groups of 128) is factored by the first warp column by
//            column in shared memory and solved there instead;
//   pass 4   the owners form Vxx (upper triangle, mirrored) and Vx; K and d
//            are stored coalesced.
//
// Four group barriers per knot (six with SOC blocks) and one block barrier.
// Every m up to 16 (the register Cholesky's range) compiles as a constant
// in the groups of 64, with a register row of 8 (kRegM) up to m = 8 and of
// 16 (kRegWide) above, so the factor, the solves and the loops over m
// unroll without guards; n stays a runtime width (a constant n as well
// gains far less than a constant m: PERF.md, kernel B's constant widths).
// The knot loop must stay small: unrolling each owned entry and each entry
// kind separately takes ~20k instructions per instantiation, and the warps
// then stall on instruction fetch.
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
#include "wide.cuh"
#include "wide_entry.cuh"

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
// row i of Quu + reg I. kRegM for the m <= 8 bodies, kRegWide for the
// narrow body above them (8 < m <= 16), each with its register width.
constexpr int kRegM = 8;
constexpr int kRegWide = 16;
constexpr unsigned kFull = 0xffffffffu;

// Quu + reg I = L L', factored by the group's first warp with row i in the
// registers of lane i (m <= RM): per column, one shuffle broadcasts the
// pivot and each later row's update takes that column's entries of the
// rows above by shuffles; no barrier. Summation order as column by column:
// entry (i, j) subtracts L(i, p) L(j, p) for p = 0, 1, ... L and the
// pivots' reciprocals go to Lc and Linv for the solves. Lanes past m
// factor a copy of row 0 and store nothing.
template <int RM, typename T>
__device__ __forceinline__ void factor_shfl(const Work<T>& wk, T* Lc, T* Linv,
                                            T regb, int m, int lane) {
  const int i = lane < m ? lane : 0;
  T a[RM];
#pragma unroll
  for (int j = 0; j < RM; ++j)
    a[j] = j < m ? wk.Quu[i * m + j] + (j == i ? regb : T(0)) : T(0);
  T inv = T(0);
#pragma unroll
  for (int j = 0; j < RM; ++j) {
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
      for (int k = j + 1; k < RM; ++k) {
        if (k < m) {
          const T lkj = __shfl_sync(kFull, a[j], k);
          if (lane >= k) a[k] -= a[j] * lkj;
        }
      }
    }
  }
  if (lane < m) {
#pragma unroll
    for (int j = 0; j < RM; ++j)
      if (j <= lane) Lc[lane * m + j] = a[j];
    Linv[lane] = inv;
  }
}

// Column c of (K | d) = -(L L')^-1 (Qux | Qu) in registers (m <= RM),
// with L and its pivots' reciprocals read from shared memory (one address
// for all the solving threads); then its column of Quu K, or, for the d
// column (c = n), Quu d and the dV sums.
template <int RM, typename T>
__device__ __forceinline__ void solve_column_regs(const Work<T>& wk,
                                                  const T* Lc, const T* Linv,
                                                  int n, int m, int c, T* dv1,
                                                  T* dv2) {
  T col[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (i < m) {
      T s = c < n ? -wk.Qux[i * n + c] : -wk.Qu[i];
#pragma unroll
      for (int p = 0; p < i; ++p) s -= Lc[i * m + p] * col[p];
      col[i] = s * Linv[i];
    }
  }
#pragma unroll
  for (int i = RM - 1; i >= 0; --i) {
    if (i < m) {
      T s = col[i];
#pragma unroll
      for (int p = i + 1; p < RM; ++p)
        if (p < m) s -= Lc[p * m + i] * col[p];
      col[i] = s * Linv[i];
    }
  }
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (i < m) {
      wk.KD[c * m + i] = col[i];
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < RM; ++p)
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
  const int N1 = N - 1;
  // grid.y runs over the groups of scenarios that share a dynamics stack
  // (one group of Bt when the dynamics are shared): a block's scenarios
  // all lie in its group, whose A and B rows it stages once for them
  const int reps = Bt / (int)gridDim.y;
  const int lane0 = (int)blockIdx.y * reps;
  A += (size_t)blockIdx.y * N1 * n * n;
  Bm += (size_t)blockIdx.y * N1 * n * m;
  const int b0 = blockIdx.x * gpb;  // in the group
  const int b_raw = b0 + grp;
  const bool active = b_raw < reps;
  // a spare group mirrors the group's last scenario
  const int b = lane0 + (active ? b_raw : reps - 1);

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
      const size_t bb = (size_t)(lane0 + min(b0 + gi, reps - 1));
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
      if constexpr (MM > kRegM) {
        // the narrow body above m = 8: the dispatch keeps n <= 21, so the
        // factor and the n + 1 solves all sit in the first warp
        if (t < 32) {
          factor_shfl<kRegWide>(wk, Lc, wk.Linv, regb, m, t);
          __syncwarp();
          if (t <= n)
            solve_column_regs<kRegWide>(wk, Lc, wk.Linv, n, m, t, &dv1,
                                        &dv2);
        }
      } else if (m <= kRegM) {
        if (n < 32) {
          // the factor and the n + 1 solves all sit in the first warp
          if (t < 32) {
            factor_shfl<kRegM>(wk, Lc, wk.Linv, regb, m, t);
            __syncwarp();
            if (t <= n)
              solve_column_regs<kRegM>(wk, Lc, wk.Linv, n, m, t, &dv1, &dv2);
          }
        } else {
          if (t < 32) factor_shfl<kRegM>(wk, Lc, wk.Linv, regb, m, t);
          altro::group_sync(bar, TG);
          if (t <= n)
            solve_column_regs<kRegM>(wk, Lc, wk.Linv, n, m, t, &dv1, &dv2);
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
                 int Bt, int NG, int N, int n, int m, int P,
                 cudaStream_t stream) {
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
  // grid (blocks of a group, groups): no block straddles two groups
  const dim3 grid((unsigned)((Bt / NG + gpb - 1) / gpb), (unsigned)NG);
  fused_expand_backward_kernel<T, TG, MM>
      <<<grid, gpb * TG, bytes, stream>>>(
          (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,
          (const T*)A, (const T*)Bm, (const T*)Cx, (const T*)Cu,
          (const T*)cb, (const T*)cmask, table, (const T*)X, (const T*)U,
          (const T*)rho, (const T*)reg, (T*)K, (T*)d, (T*)dV1, (T*)dV2, Bt,
          N, n, m, P);
  return (int)cudaGetLastError();
}

// The wide body, for n or m above kNarrowDim (up to kMaxDim) and n + m
// above kEntryWidth (the entry body below takes the narrower end); it
// replaces the TPU kernel altro_tpu/ops/riccati_fused.py:
// fused_expand_backward at those widths, and computes its formulas
// (riccati_fused.py:220-295).
//
// One block works one scenario: 128 threads at a narrow control (the
// state_dim sweep's n = 45, 55 with m = 2: four scenarios per SM), 512 at
// n = m = 64. The expansion's dynamics terms are two block-wide products
// per knot over the concatenated width W = n + m, with F = [A | B] the
// knot's shared dynamics rows and C = [Cx | Cu] its constraint rows:
//
//   G = Vxx F                                    [n x W]
//   Qfull = F'G + C' diag(w) C   (upper triangle) [W x W]
//         = [Qxx Qxu; . Quu], each 4 x 4 tile's sums seeded with its cost
//           entries and the SOC blocks' rank-1 terms; F'Vx + C'g rides along
//           as one extra column (Qx, Qu).
//
// The shared rows come into shared memory by cp.async (16-byte copies when
// n and m allow), never read per FMA: where two stages of n + P rows fit,
// one stage per knot holds F and C (the next knot's lands while the knot
// is worked); else (n = m = 64 in float64) a ring of 16-row panels, two
// to four stages, takes F twice and C in the products' order. At a knot's
// start its constraint rows, Q and R go into G's region and its H into
// Qux's place, so that the group body's helpers for the rows' scalars
// (row_terms, soc_scalars, soc_rows, rank_terms) and the cost part
// of Qx and Qu (one thread per entry) read shared memory. Each thread owns
// up to two tiles of G and one of Qfull (512 threads: one and two) and per
// row of a stage reads one 4-vector of each operand; the expansion is then
// written straight into the Riccati tail's layout, whose blocked factor,
// solves, Quu K and V are wide.cuh's. The lane's x, u, multipliers and rho
// for knot k-1 are loaded into registers during knot k. The products and
// the tail are separate non-inlined functions, so that each gets the
// registers it needs (inlined into one body they spilled their tiles' sums
// at 128 registers).
//
// Work space (WideLayout): at n = m = 64 with 12 rows and one SOC block,
// ~224 KB in float64 (a three-stage ring) and ~165 KB in float32 (one
// stage per knot): G takes the region that the constraint rows take before
// it and aug and Quu K after it, and Quu lies in aug's strict lower
// triangle, so no matrix is held twice.
//
// What bounds it on the H100: at n = m = 64, N = 21, B = 1024 its FLOPs
// (~98 GFLOP, 1.46 ms at 67 TFLOP/s in float32), against ~0.4 GB of bytes
// (0.12 ms); at the state_dim sweep's m = 2 and one scenario, the chain of
// a knot's phases (about a dozen barriers). Tensor cores are not used: the
// port pins float32 products to full precision, which bars TF32
// mma/wgmma, and double-precision mma.sync (DMMA) is a later step
// (ROADMAP.md §2) that would pay only where the products, not the tail's
// barriers, hold the body back.

// Rows per ring stage where a knot's F and C do not fit one (n = m = 64 in
// float64), and the block sizes: 128 threads while G's tiles fit two per
// thread, Qfull's one and the lane's inputs one (the state_dim sweep's
// n <= 55, m = 2: four scenarios per SM), 512 above.
constexpr int kRing = 16;
// Up to this n + m the entry body (below) runs instead: it is faster at
// the state_dim sweep's n = 35, m = 2, the tiled body from n = 45 on, in
// both dtypes and at one lane and 1024, but for float64 at one lane,
// where the crossover lies between n = 45 and 55 (PERF.md,
// bench/kernels.py's wide rows).
constexpr int kEntryWidth = 40;
constexpr int kSmallThreads = 128;
constexpr int kLargeThreads = 512;

// Where the knot's rows staged at its start lie in the region: Cx [P x n]
// and Cu [P x m] from its start, then b [P], mask [P], then Q [n x n] and
// R [m x m], each 16-byte aligned.
struct KnotRows {
  int ob, oq, orr, size;
  __host__ __device__ KnotRows(int n, int m, int P) {
    using altro::wide::pad4;
    ob = pad4(P * (n + m));
    oq = ob + pad4(2 * P);
    orr = oq + pad4(n * n);
    size = orr + pad4(m * m);
  }
};

// Offsets (in elements) of the wide body's shared memory: the lane's x, u,
// multipliers and rho; z, g, w; the cost part of Qx, Qu (qc); Qx, Vx, Qu,
// qdiag, inv; the SOC scratch; then, 16-byte aligned, Vq, Qux, the region
// (the knot's Cx, Cu, b, mask, Q and R, then G, then aug and Quu K) and the ring
// of `depth` stages of kp rows.
struct WideLayout {
  int lane, z, g, w, qc, Qx, Vx, Qu, qdiag, inv, soc, Vq, Qux, region, ring,
      total;
  __host__ __device__ WideLayout(int n, int m, int P, int nsoc, int kp,
                                 int depth) {
    const altro::wide::TailDims td(n, m);
    const int Wp = altro::wide::pad4(n + m);
    lane = 0;
    z = lane + n + m + P + 1;
    g = z + P;
    w = g + P;
    qc = w + P;
    Qx = qc + n + m;
    Vx = Qx + n;
    Qu = Vx + n;
    qdiag = Qu + m;
    inv = qdiag + m;
    soc = inv + m;
    Vq = altro::wide::pad4(soc + nsoc * soc_elems(n, m));
    Qux = Vq + n * td.ldn;
    region = Qux + m * td.ldn;
    const int g_elems = n * Wp, tail_elems = m * (td.lda + td.ldk);
    const int rows_elems = KnotRows(n, m, P).size;
    int rg = g_elems > tail_elems ? g_elems : tail_elems;
    rg = rg > rows_elems ? rg : rows_elems;
    ring = region + altro::wide::pad4(rg);
    total = ring + depth * kp * Wp;
  }
};

// The ring: `depth` stages of kp rows of [A | B] or [Cx | Cu], depth - 1 of
// them in flight, in the order the products take them (knot k < N1: F for
// G, F again and C for Qfull; the terminal knot: C), from knot N1 down; or,
// where two stages of n + P rows fit (`whole`), one stage per knot with F
// and C together, taken once by both products.
template <typename T>
struct Ring {
  const T *A, *Bm, *Cx, *Cu;
  T* base;
  int n, m, P, N1, Wp, kp, nF, nC, depth, vec;
  altro::Spread spn, spm;  // a thread's place in rows of n and of m
  int ik, ii, islot, uslot;
  bool whole;  // one stage per knot: F in rows 0..n-1, C in rows n..n+P-1

  __device__ int panels(int k) const {
    return whole ? 1 : (k < N1 ? 2 * nF : 0) + nC;
  }

  __device__ void issue() {
    if (ik < 0) return;
    T* dst = base + islot * kp * Wp;
    if (whole) {
      if (ik < N1) {
        altro::stage_rows(dst, Wp, A + (size_t)ik * n * n, n, n, vec, spn);
        altro::stage_rows(dst + n, Wp, Bm + (size_t)ik * n * m, n, m, vec,
                          spm);
      }
      altro::stage_rows(dst + n * Wp, Wp, Cx + (size_t)ik * P * n, P, n, vec,
                        spn);
      altro::stage_rows(dst + n * Wp + n, Wp, Cu + (size_t)ik * P * m, P, m,
                        vec, spm);
      altro::cp_async_commit();
      if (++islot == depth) islot = 0;
      --ik;
      return;
    }
    const int f = ik < N1 ? 2 * nF : 0;
    const bool dyn = ii < f;
    const int r0 = (dyn ? (ii < nF ? ii : ii - nF) : ii - f) * kp;
    const int rows = min(kp, (dyn ? n : P) - r0);
    const T* s1 = dyn ? A + ((size_t)ik * n + r0) * n
                      : Cx + ((size_t)ik * P + r0) * n;
    const T* s2 = dyn ? Bm + ((size_t)ik * n + r0) * m
                      : Cu + ((size_t)ik * P + r0) * m;
    altro::stage_rows(dst, Wp, s1, rows, n, vec, spn);
    altro::stage_rows(dst + n, Wp, s2, rows, m, vec, spm);
    altro::cp_async_commit();
    if (++islot == depth) islot = 0;
    if (++ii == panels(ik)) {
      ii = 0;
      --ik;
    }
  }

  // the next panel, landed and visible; every thread is past the panel
  // before it, whose stage the next issue takes (at least depth - 2 commit
  // groups follow the panel's own)
  __device__ const T* acquire() {
    if (depth == 4)
      altro::cp_async_wait_group<2>();
    else if (depth == 3)
      altro::cp_async_wait_group<1>();
    else
      altro::cp_async_wait_all();
    __syncthreads();
    const T* cur = base + uslot * kp * Wp;
    if (++uslot == depth) uslot = 0;
    issue();
    return cur;
  }
};

// G = Vxx F [n x W] (Vxx symmetric: row p of Vxx is its column p), up to KT
// 4 x 4 tiles per thread, from nF panels of the ring or the knot's `whole`
// stage.
template <typename T, int KT>
__device__ __noinline__ void dynamics_product(Ring<T>* rg, const T* Vq,
                                              int ldn, T* G,
                                              const T* whole) {
  namespace wd = altro::wide;
  const int n = rg->n, Wp = rg->Wp, kp = rg->kp, W4 = Wp / 4;
  const int t = threadIdx.x, nt = blockDim.x, tiles = (n + 3) / 4 * W4;
  T acc[KT][4][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) wd::zero4(acc[s]);
  for (int f = 0; f < (whole ? 1 : rg->nF); ++f) {
    const T* pan = whole ? whole : rg->acquire();
    const int p0 = f * kp, kc = whole ? n : min(kp, n - p0);
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      const int q = t + s * nt;
      if (q >= tiles) break;
      const int i0 = q / W4 * 4, j0 = q % W4 * 4;
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        T av[4], bv[4];
        wd::ld4(Vq + (p0 + kk) * ldn + i0, av);
        wd::ld4(pan + kk * Wp + j0, bv);
        wd::outer4(acc[s], av, bv);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const int q = t + s * nt;
    if (q >= tiles) break;
    const int i0 = q / W4 * 4, j0 = q % W4 * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r >= n) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) G[(i0 + r) * Wp + j0 + c] = acc[s][r][c];
    }
  }
}

// What the expansion pass reads and writes (shared memory unless noted).
template <typename T>
struct ExpansionArgs {
  const T* G;     // V F [n x Wp]
  Work<T> wk;     // g, w, soc
  const T* qc;    // the cost part of Qx, Qu [W]
  const T* Qs;    // the knot's Q [n x ldq] and R [m x ldr] in device
  const T* Hs;    // memory, its H [m x ldh] staged in Qux's place
  const T* Rs;
  int ldq, ldh, ldr;
  T regb;
  int term, nsoc;
};

// Qfull = F'G + C' diag(w) C over the upper triangle of [W x W] (at the
// terminal knot C'WC over the x block), up to KT 4 x 4 tiles per thread,
// from the ring's panels or the knot's `whole` stage, each tile's sums
// seeded with its cost entries (Q, H or R, loaded from device memory while
// the first panel lands) and the SOC blocks' rank-1 terms; the extra
// column F'Vx + C'g on the first Wo threads. Then, once G is read no
// more, the expansion in the tail's layout: Qxx (upper) in Vq,
// Qux and -Qux into aug's right-hand sides, Quu + reg I (upper) and Quu
// (strict lower, diagonal in qdiag) into aug, Qx and Qu. Ends on a barrier.
template <typename T, int KT>
__device__ __noinline__ void expansion(Ring<T>* rg,
                                       const altro::wide::Tail<T> tl,
                                       const ExpansionArgs<T> ea,
                                       const T* whole) {
  namespace wd = altro::wide;
  const int n = rg->n, m = rg->m, P = rg->P, Wp = rg->Wp, kp = rg->kp;
  const int W4 = Wp / 4, W = n + m, Wo = ea.term ? n : W, nsoc = ea.nsoc;
  const int t = threadIdx.x, nt = blockDim.x;
  const int ldn = tl.ldn, lda = tl.lda, ma = tl.ma;
  int i2[KT], j2[KT];
  bool act[KT];
  T acc[KT][4][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    int I = 0, J = 0;
    act[s] = t + s * nt < W4 * (W4 + 1) / 2;
    if (act[s]) wd::upper_ij(t + s * nt, W4, &I, &J);
    i2[s] = 4 * I;
    j2[s] = 4 * J;
    act[s] = act[s] && (!ea.term || j2[s] < n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i2[s] + r, j = j2[s] + c;
        const bool in = act[s] && i <= j && j < Wo;
        const int kind = j < n ? 0 : i < n ? 1 : 2;  // Qxx, Qxu, Quu
        const T* src = kind == 0   ? ea.Qs + i * ea.ldq + j
                       : kind == 1 ? ea.Hs + (j - n) * ea.ldh + i
                                   : ea.Rs + (i - n) * ea.ldr + (j - n);
        acc[s][r][c] = in ? *src : T(0);
      }
  }
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    if (!act[s] || nsoc == 0) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i2[s] + r, j = j2[s] + c;
        if (i > j || j >= Wo) continue;
        acc[s][r][c] += j < n ? rank_terms(ea.wk.soc, nsoc, n, m, 0, i, 0, j)
                        : i < n
                            ? rank_terms(ea.wk.soc, nsoc, n, m, 2 * n, j - n, 0, i)
                            : rank_terms(ea.wk.soc, nsoc, n, m, 2 * n, i - n,
                                         2 * n, j - n);
      }
  }
  T gv = T(0);
  if (!ea.term) {
    for (int f = 0; f < (whole ? 1 : rg->nF); ++f) {
      const T* pan = whole ? whole : rg->acquire();
      const int p0 = f * kp, kc = whole ? n : min(kp, n - p0);
      if (t < W)
        for (int kk = 0; kk < kc; ++kk) gv += pan[kk * Wp + t] * tl.Vx[p0 + kk];
#pragma unroll
      for (int s = 0; s < KT; ++s) {
        if (!act[s]) continue;
#pragma unroll 2
        for (int kk = 0; kk < kc; ++kk) {
          T av[4], bv[4];
          wd::ld4(pan + kk * Wp + i2[s], av);
          wd::ld4(ea.G + (p0 + kk) * Wp + j2[s], bv);
          wd::outer4(acc[s], av, bv);
        }
      }
    }
  }
  for (int f = 0; f < (whole ? (P > 0) : rg->nC); ++f) {
    const T* pan = whole ? whole + n * Wp : rg->acquire();
    const int r0 = f * kp, kc = whole ? P : min(kp, P - r0);
    if (t < Wo)
      for (int kk = 0; kk < kc; ++kk) gv += pan[kk * Wp + t] * ea.wk.g[r0 + kk];
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      if (!act[s]) continue;
#pragma unroll 2
      for (int kk = 0; kk < kc; ++kk) {
        const T wr = ea.wk.w[r0 + kk];
        T av[4], bv[4];
        wd::ld4(pan + kk * Wp + i2[s], av);
        wd::ld4(pan + kk * Wp + j2[s], bv);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] *= wr;
        wd::outer4(acc[s], av, bv);
      }
    }
  }
  // G is read no more: aug and Quu K take its place
  __syncthreads();
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    if (!act[s]) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i2[s] + r, j = j2[s] + c;
        if (i > j || j >= Wo) continue;
        const T v = acc[s][r][c];
        if (j < n) {
          tl.Vq[i * ldn + j] = v;
        } else if (i < n) {
          tl.Qux[(j - n) * ldn + i] = v;
          tl.aug[(j - n) * lda + ma + i] = -v;
        } else {
          const int a = i - n, cc = j - n;
          if (a == cc) {
            tl.aug[a * lda + a] = v + ea.regb;
            tl.qdiag[a] = v;
          } else {
            tl.aug[a * lda + cc] = v;
            tl.aug[cc * lda + a] = v;
          }
        }
      }
    }
  }
  if (t < Wo) {
    const T v = ea.qc[t] + gv;
    if (t < n) {
      tl.Qx[t] = v;
    } else {
      tl.Qu[t - n] = v;
      tl.aug[(t - n) * lda + ma + n] = -v;
    }
  }
  __syncthreads();
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT, NT == kSmallThreads ? 4 : 1)
fused_expand_backward_wide(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ rho, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int NG, int N, int n, int m, int P,
    int vec, int kp, int depth) {
  namespace wd = altro::wide;
  // 4 x 4 tiles per thread: G has at most 16 x 32 = 512 (the small blocks:
  // 256), Qfull's upper triangle at most 32 x 33 / 2 = 528 (128)
  constexpr int kT1 = NT == kSmallThreads ? 2 : 1;
  constexpr int kT2 = NT == kSmallThreads ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  __shared__ int8_t row_blk[altro::kMaxRows];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, N1 = N - 1;
  // the scenario's group's dynamics (NG = 1: shared)
  A += (size_t)(b / (Bt / NG)) * N1 * n * n;
  Bm += (size_t)(b / (Bt / NG)) * N1 * n * m;
  if (t == 0) tab = table;
  for (int rr = t; rr < P; rr += nt) {
    int bi = 0;
    while (bi + 1 < table.count && rr >= table.row0[bi + 1]) ++bi;
    row_blk[rr] = (int8_t)bi;
  }
  __syncthreads();
  const int nsoc = tab.nsoc;

  const WideLayout lo(n, m, P, nsoc, kp, depth);
  const wd::TailDims td(n, m);
  T* x = smem + lo.lane;
  T* u = x + n;
  T* lam = u + m;
  T* G = smem + lo.region;
  T* qc = smem + lo.qc;
  Work<T> wk{};
  wk.z = smem + lo.z;
  wk.g = smem + lo.g;
  wk.w = smem + lo.w;
  wk.soc = smem + lo.soc;
  const wd::Tail<T> tl{smem + lo.Vq, smem + lo.Qx, smem + lo.Vx,
                       smem + lo.Qux, smem + lo.Qu, G, smem + lo.qdiag,
                       smem + lo.inv, G + m * td.lda, n, m, td.ldn, td.ldk,
                       td.ma, td.lda};
  const int v = vec ? 16 / (int)sizeof(T) : 1;
  Ring<T> ring{A, Bm, Cx, Cu, smem + lo.ring, n, m, P, N1, wd::pad4(n + m),
               kp, (n + kp - 1) / kp, (P + kp - 1) / kp, depth, vec,
               altro::Spread(n / v, t, nt), altro::Spread(m / v, t, nt),
               0, 0, 0, 0, kp >= n + P};
  ring.ik = ring.panels(N1) ? N1 : N1 - 1;
  for (int i = 1; i < depth; ++i) ring.issue();

  // the lane's x, u, multipliers and rho of knot k (u = 0 at the terminal),
  // loaded into a register one knot ahead
  const int nlane = n + m + P + 1;
  auto lane_val = [&](int k) -> T {
    if (t < n) return X[((size_t)b * N + k) * n + t];
    if (t < n + m)
      return k == N1 ? T(0) : U[((size_t)b * N1 + k) * m + (t - n)];
    if (t < n + m + P) {
      const int rr = t - n - m, bi = row_blk[rr];
      return tab.lam[bi][((size_t)b * N + k) * tab.p[bi] +
                         (rr - tab.row0[bi])];
    }
    return rho[(size_t)b * N + k];
  };
  T nxt = t < nlane ? lane_val(N1) : T(0);
  const T regb = reg[b];
  T dv1 = T(0), dv2 = T(0);

  for (int k = N1; k >= 0; --k) {
    const bool term = k == N1;
    // the knot's constraint rows, Q and R into the region (free until G),
    // its H into Qux's place (free until the expansion)
    T* crows = G;
    const KnotRows kr(n, m, P);
    if (P) {
      altro::stage_rows(crows, n, Cx + (size_t)k * P * n, P, n, vec,
                        ring.spn);
      altro::stage_rows(crows + P * n, m, Cu + (size_t)k * P * m, P, m, vec,
                        ring.spm);
      altro::stage_vec(crows + kr.ob, cb + (size_t)k * P, P, t);
      altro::stage_vec(crows + kr.ob + P, cmask + (size_t)k * P, P,
                       nt - 1 - t);
    }
    altro::stage_rows(crows + kr.oq, n, Q + (size_t)k * n * n, n, n, vec,
                      ring.spn);
    if (!term) {
      altro::stage_rows(crows + kr.orr, m, R + (size_t)k * m * m, m, m, vec,
                        ring.spm);
      altro::stage_rows(tl.Qux, td.ldn, H + (size_t)k * m * n, m, n, vec,
                        ring.spn);
    }
    altro::cp_async_commit();
    if (t < nlane) x[t] = nxt;
    if (k > 0 && t < nlane) nxt = lane_val(k - 1);
    altro::cp_async_wait_all();
    __syncthreads();
    const T rk = x[n + m + P];
    Knot<T> kn;
    kn.Q = kn.q = kn.R = kn.r = kn.H = kn.A = kn.B = nullptr;
    kn.Cx = crows;
    kn.Cu = crows + P * n;
    kn.b = crows + kr.ob;
    kn.mask = kn.b + P;

    // the rows' z, g, w (the first P threads); the cost part of Qx and Qu,
    // q + Q x + H'u and r + R u + H x, from the staged rows (the last Wo
    // threads, one entry each); the SOC blocks' scalars and projections
    row_terms(tab, row_blk, kn, x, u, lam, rk, !term, n, m, P, wk, t, nt);
    {
      const int e = nt - 1 - t, Wo = term ? n : n + m;
      const T* Qs = crows + kr.oq;
      const T* Rs = crows + kr.orr;
      if (e < Wo) {
        T a;
        if (e < n) {
          a = q[(size_t)k * n + e];
          for (int p = 0; p < n; ++p) a += Qs[e * n + p] * x[p];
          if (!term)
            for (int p = 0; p < m; ++p) a += tl.Qux[p * td.ldn + e] * u[p];
        } else {
          const int i = e - n;
          a = r[(size_t)k * m + i];
          for (int p = 0; p < m; ++p) a += Rs[i * m + p] * u[p];
          for (int p = 0; p < n; ++p) a += tl.Qux[i * td.ldn + p] * x[p];
        }
        qc[e] = a;
      }
    }
    __syncthreads();
    if (nsoc) {
      soc_scalars(tab, kn, rk, n, m, wk, t, nt);
      __syncthreads();
      soc_rows(tab, row_blk, kn, rk, !term, n, m, P, wk, t, nt);
      __syncthreads();
    }

    const T* whole = ring.whole ? ring.acquire() : nullptr;
    if (!term) {
      dynamics_product<T, kT1>(&ring, tl.Vq, td.ldn, G, whole);
      if (whole) __syncthreads();  // G whole before the expansion reads it
    }
    const ExpansionArgs<T> ea{G,
                              wk,
                              qc,
                              Q + (size_t)k * n * n,
                              tl.Qux,
                              R + (size_t)k * m * m,
                              n,
                              td.ldn,
                              m,
                              regb,
                              term,
                              nsoc};
    expansion<T, kT2>(&ring, tl, ea, whole);

    // the Riccati tail: (K | d), Quu K, V; K and d stored
    if (!term) {
      wd::factor_solve(tl);
      wd::quu_k(tl);
      __syncthreads();
    }
    wd::value(tl, term, &dv1, &dv2);
    if (!term)
      wd::store_gains(tl, Kout + ((size_t)b * N1 + k) * m * n,
                      dout + ((size_t)b * N1 + k) * m);
    __syncthreads();
  }
  if (t == 0) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
}

template <typename T, int NT>
int launch_wide_nt(const void* Q, const void* q, const void* R,
                   const void* r, const void* H, const void* A,
                   const void* Bm, const void* Cx, const void* Cu,
                   const void* cb, const void* cmask,
                   const altro::BlockTable<T>& table, const void* X,
                   const void* U, const void* rho, const void* reg, void* K,
                   void* d, void* dV1, void* dV2, int Bt, int NG, int N,
                   int n, int m, int P, cudaStream_t stream) {
  auto kern = fused_expand_backward_wide<T, NT>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  const size_t cap = 232448 - attr.sharedSizeBytes;
  auto bytes_of = [&](int kp, int depth) {
    return (size_t)WideLayout(n, m, P, table.nsoc, kp, depth).total *
           sizeof(T);
  };
  // one stage of n + P rows per knot where two such stages fit, else
  // kRing rows in the deepest ring (4 stages down to 2) that fits
  int kp = n + P, depth = 2;
  if (bytes_of(kp, 2) > cap) {
    kp = kRing;
    for (depth = 4; depth > 2 && bytes_of(kp, depth) > cap; --depth) {
    }
  }
  const size_t bytes = bytes_of(kp, depth);
  e = altro::wide::prepare(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies of the staged rows when every row starts aligned
  const int v = 16 / (int)sizeof(T);
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = n % v == 0 && m % v == 0 && aligned(Q) && aligned(R) &&
                  aligned(H) && aligned(A) && aligned(Bm) && aligned(Cx) &&
                  aligned(Cu);
  kern<<<Bt, NT, bytes, stream>>>(
      (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,
      (const T*)A, (const T*)Bm, (const T*)Cx, (const T*)Cu, (const T*)cb,
      (const T*)cmask, table, (const T*)X, (const T*)U, (const T*)rho,
      (const T*)reg, (T*)K, (T*)d, (T*)dV1, (T*)dV2, Bt, NG, N, n, m, P, vec,
      kp, depth);
  return (int)cudaGetLastError();
}

// The entry body, the wide body's narrow end (n + m <= kEntryWidth: the
// state_dim sweep's n = 35 with m = 2): one block of wide::kWideThreads
// threads per scenario, the knot rows read from device memory, the lane's
// x, u and multipliers staged per knot, and the whole work space (Qxx's
// upper triangle in Vxx's place, Qx beside it) in shared memory. Pass 1
// and 2 are the group body's (row_terms, the SOC passes, expansion_entry);
// the Riccati tail is wide_entry.cuh's. At this width a knot is a short
// chain of barriers over one entry per thread and eight scenarios share an
// SM, where the tiled body's staging and tiles cost more than they save
// (PERF.md: the two bodies on either side of kEntryWidth).
template <typename T>
__global__ void __launch_bounds__(altro::wide::kWideThreads)
fused_expand_backward_wide_entry(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ rho, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int NG, int N, int n, int m, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  __shared__ int8_t row_blk[altro::kMaxRows];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int TG = blockDim.x, t = threadIdx.x;
  const int b = blockIdx.x, N1 = N - 1;
  // the scenario's group's dynamics (NG = 1: shared)
  A += (size_t)(b / (Bt / NG)) * N1 * n * n;
  Bm += (size_t)(b / (Bt / NG)) * N1 * n * m;
  if (t == 0) tab = table;
  for (int rr = t; rr < P; rr += TG) {
    int bi = 0;
    while (bi + 1 < table.count && rr >= table.row0[bi + 1]) ++bi;
    row_blk[rr] = (int8_t)bi;
  }
  __syncthreads();
  const int nsoc = tab.nsoc;

  T* x = smem;
  T* u = x + n;
  T* lam = u + m;
  T* Qx = lam + P;
  Work<T> wk;
  wk.Vx = Qx + n;
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
  wk.KD = wk.VB + n * m;
  wk.soc = wk.KD + (n + 1) * m;
  T* Lc = wk.VA;  // the Cholesky factor, after V A's last use
  T* QuuK = wk.VB;

  const int n_tri = n * (n + 1) / 2;
  const int n_own = owned_entries(n);
  const int n_shared = shared_entries(m, n);
  const T regb = reg[b];
  T dv1 = T(0), dv2 = T(0);
  for (int k = N1; k >= 0; --k) {
    const bool term = k == N1;
    Knot<T> kn;
    kn.Q = Q + (size_t)k * n * n;
    kn.q = q + (size_t)k * n;
    kn.R = R + (size_t)k * m * m;
    kn.r = r + (size_t)k * m;
    kn.H = H + (size_t)k * m * n;
    kn.A = term ? A : A + (size_t)k * n * n;  // not read at the terminal
    kn.B = term ? Bm : Bm + (size_t)k * n * m;
    kn.Cx = Cx + (size_t)k * P * n;
    kn.Cu = Cu + (size_t)k * P * m;
    kn.b = cb + (size_t)k * P;
    kn.mask = cmask + (size_t)k * P;
    for (int e = t; e < n + m + P; e += TG) {
      if (e < n) {
        x[e] = X[((size_t)b * N + k) * n + e];
      } else if (e < n + m) {
        u[e - n] = term ? T(0) : U[((size_t)b * N1 + k) * m + (e - n)];
      } else {
        const int rr = e - n - m, bi = row_blk[rr];
        lam[rr] = tab.lam[bi][((size_t)b * N + k) * tab.p[bi] +
                              (rr - tab.row0[bi])];
      }
    }
    const T rk = rho[(size_t)b * N + k];
    __syncthreads();

    // pass 1: the rows' z, g, w; V A and V B
    row_terms(tab, row_blk, kn, x, u, lam, rk, !term, n, m, P, wk, t, TG);
    if (!term)
      altro::wide_entry::vab(wk.Vxx, kn.A, kn.B, wk.VA, wk.VB, n, m);
    __syncthreads();
    if (nsoc) {
      soc_scalars(tab, kn, rk, n, m, wk, t, TG);
      __syncthreads();
      soc_rows(tab, row_blk, kn, rk, !term, n, m, P, wk, t, TG);
      __syncthreads();
    }
    // pass 2: every expansion entry; Qxx's upper triangle in Vxx's place
    const int n_all = term ? n_own : n_own + n_shared;
    for (int e = t; e < n_all; e += TG) {
      int d1 = 0, d2 = 0;
      const T v = expansion_entry(kn, wk, x, u, term, nsoc, n, m, P, e, &d1,
                                  &d2);
      if (e < n_tri) {
        int i, j;
        upper_ij(e, n, &i, &j);
        wk.Vxx[i * n + j] = v;
      } else if (e < n_own) {
        Qx[e - n_tri] = v;
      } else {
        wk.Qu[d1] = v;
        wk.Qu[d2] = v;
      }
    }
    __syncthreads();
    if (!term) {
      // pass 3: (K | d), Quu K, Quu d, dV
      altro::wide_entry::factor(wk.Quu, Lc, regb, m);
      altro::wide_entry::solve(Lc, wk.Quu, wk.Qux, wk.Qu, wk.KD, QuuK,
                               wk.Quud, n, m, &dv1, &dv2);
      __syncthreads();
    }
    // pass 4: V; K and d stored
    altro::wide_entry::value(wk.Vxx, wk.Vx, Qx, wk.KD, QuuK, wk.Qux,
                             wk.Quud, wk.Qu, term, n, m);
    if (!term)
      altro::wide_entry::store_gains(
          wk.KD, Kout + ((size_t)b * N1 + k) * m * n,
          dout + ((size_t)b * N1 + k) * m, n, m);
    __syncthreads();
  }
  if (t == n) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
}

template <typename T>
int launch_wide_entry(const void* Q, const void* q, const void* R,
                      const void* r, const void* H, const void* A,
                      const void* Bm, const void* Cx, const void* Cu,
                      const void* cb, const void* cmask,
                      const altro::BlockTable<T>& table, const void* X,
                      const void* U, const void* rho, const void* reg,
                      void* K, void* d, void* dV1, void* dV2, int Bt, int NG,
                      int N, int n, int m, int P, cudaStream_t stream) {
  const size_t bytes =
      (size_t)(2 * n + m + P + work_elems(n, m, P, table.nsoc)) * sizeof(T);
  cudaError_t e =
      altro::wide::prepare(fused_expand_backward_wide_entry<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  fused_expand_backward_wide_entry<T>
      <<<Bt, altro::wide::kWideThreads, bytes, stream>>>(
          (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,
          (const T*)A, (const T*)Bm, (const T*)Cx, (const T*)Cu,
          (const T*)cb, (const T*)cmask, table, (const T*)X, (const T*)U,
          (const T*)rho, (const T*)reg, (T*)K, (T*)d, (T*)dV1, (T*)dV2, Bt,
          NG, N, n, m, P);
  return (int)cudaGetLastError();
}

// The body kernel B takes at a shape (n, m, P), or -1 where it takes none;
// launch_fused dispatches on it and the wrapper names it by its place in
// ops/riccati_fused.py: BODIES (the loop graphs' capture spans carry it).
enum Body : int {
  kNarrowM8,   // m <= kRegM, groups of 64, m a constant: the register factor
  kNarrowM16,  // kRegM < m <= kRegWide, groups of 64, m a constant, the
               // factor and the solves in registers, n <= 21
  kGroup64,    // any other m within kSmallEntries entries: groups of 64
  kGroup128,   // above kSmallEntries entries: groups of 128
  kWideEntry,  // n or m above kNarrowDim, n + m <= kEntryWidth
  kWideSmall,  // the tiled body in blocks of kSmallThreads
  kWideLarge,  // the tiled body in blocks of kLargeThreads
};

int fused_body(int n, int m, int P) {
  if (n < 1 || m < 1 || n > altro::kMaxDim || m > altro::kMaxDim || P < 0 ||
      P > altro::kMaxRows)
    return -1;
  if (n > altro::kNarrowDim || m > altro::kNarrowDim) {
    if (n + m <= kEntryWidth) return kWideEntry;
    const int W4 = altro::wide::pad4(n + m) / 4;
    const bool small = (n + 3) / 4 * W4 <= 2 * kSmallThreads &&
                       W4 * (W4 + 1) / 2 <= kSmallThreads &&
                       n + m + P + 1 <= kSmallThreads;
    return small ? kWideSmall : kWideLarge;
  }
  // In groups of 64 a thread keeps kSmallEntries / 64 owned entries (Qxx's
  // upper triangle and Qx) in registers, so n <= 21; at 128 registers 8
  // such groups fit an SM and B=1024 runs in one wave. They take every
  // shape of up to kSmallEntries expansion entries (the flagship's 189)
  // and, for 8 < m <= 16, every n whose owned entries fit (the trot's 90
  // of 324; the shared entries take more slots); groups of 128 the rest
  if (m > kRegM && m <= kRegWide && owned_entries(n) <= kSmallEntries)
    return kNarrowM16;
  if (owned_entries(n) + shared_entries(m, n) > kSmallEntries)
    return kGroup128;
  return m <= kRegM ? kNarrowM8 : kGroup64;
}

template <typename T>
int launch_fused(const void* Q, const void* q, const void* R, const void* r,
                 const void* H, const void* A, const void* Bm,
                 const void* Cx, const void* Cu, const void* cb,
                 const void* cmask, int nblocks, const int* meta,
                 const void* const* lams, const void* X, const void* U,
                 const void* rho, const void* reg, void* K, void* d,
                 void* dV1, void* dV2, int Bt, int NG, int N, int n, int m,
                 int P, void* stream) {
  const int body = fused_body(n, m, P);
  if (body < 0 || N < 2 || Bt < 1 || NG < 1 || Bt % NG != 0 || NG > 65535)
    return (int)cudaErrorInvalidValue;
  altro::BlockTable<T> table;
  if (!altro::make_table(nblocks, meta, lams, P, &table))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ALTRO_FUSED_LAUNCH(L)                                               \
  L(Q, q, R, r, H, A, Bm, Cx, Cu, cb, cmask, table, X, U, rho, reg, K, d,   \
    dV1, dV2, Bt, NG, N, n, m, P, s)
#define ALTRO_FUSED_GROUP(TG, MM) ALTRO_FUSED_LAUNCH((launch_group<T, TG, MM>))
  // the narrow bodies compile every m up to kRegWide as a constant, so the
  // factor, the solves and the loops over m unroll without guards
  static_assert(kRegM == 8 && kRegWide == 16,
                "one constant-m instantiation per m <= kRegWide");
  switch (body) {
    case kWideEntry: return ALTRO_FUSED_LAUNCH(launch_wide_entry<T>);
    case kWideSmall:
      return ALTRO_FUSED_LAUNCH((launch_wide_nt<T, kSmallThreads>));
    case kWideLarge:
      return ALTRO_FUSED_LAUNCH((launch_wide_nt<T, kLargeThreads>));
    case kGroup128: return ALTRO_FUSED_GROUP(128, 0);
    case kGroup64: return ALTRO_FUSED_GROUP(64, 0);
    default: break;  // kNarrowM8, kNarrowM16: one instantiation per m
  }
  switch (m) {
    case 1: return ALTRO_FUSED_GROUP(64, 1);
    case 2: return ALTRO_FUSED_GROUP(64, 2);
    case 3: return ALTRO_FUSED_GROUP(64, 3);
    case 4: return ALTRO_FUSED_GROUP(64, 4);
    case 5: return ALTRO_FUSED_GROUP(64, 5);
    case 6: return ALTRO_FUSED_GROUP(64, 6);
    case 7: return ALTRO_FUSED_GROUP(64, 7);
    case 8: return ALTRO_FUSED_GROUP(64, 8);
    case 9: return ALTRO_FUSED_GROUP(64, 9);
    case 10: return ALTRO_FUSED_GROUP(64, 10);
    case 11: return ALTRO_FUSED_GROUP(64, 11);
    case 12: return ALTRO_FUSED_GROUP(64, 12);
    case 13: return ALTRO_FUSED_GROUP(64, 13);
    case 14: return ALTRO_FUSED_GROUP(64, 14);
    case 15: return ALTRO_FUSED_GROUP(64, 15);
    case 16: return ALTRO_FUSED_GROUP(64, 16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALTRO_FUSED_GROUP
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
      void* dV1, void* dV2, int Bt, int NG, int N, int n, int m, int P,      \
      void* stream) {                                                       \
    return launch_fused<T>(Q, q, R, r, H, A, Bm, Cx, Cu, cb, cmask,         \
                           nblocks, meta, lams, X, U, rho, reg, K, d, dV1,  \
                           dV2, Bt, NG, N, n, m, P, stream);                 \
  }

ALTRO_FUSED_ENTRY(altro_fused_expand_backward_f32, float)
ALTRO_FUSED_ENTRY(altro_fused_expand_backward_f64, double)

// The body launch_fused takes at (n, m, P): its place in ops/
// riccati_fused.py: BODIES, or -1 where the kernel takes no such shape.
extern "C" int altro_fused_expand_backward_body(int n, int m, int P) {
  return fused_body(n, m, P);
}
