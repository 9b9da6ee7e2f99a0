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
// Thread mapping: one warp per scenario, SPB scenarios (warps) per block.
// The TPU grid's sequential knot axis is a loop inside the block. Each
// knot's shared problem rows are staged into shared memory once per block;
// each warp keeps its scenario's Vx/Vxx, the Q blocks, the Cholesky factor
// and the gains in shared memory (about 900 floats at n=12, m=6, p=12: too
// many for registers) and spreads the matrix elements of every product over
// its 32 lanes. The constraint rows are spread over the lanes; an SOC
// block's |v| needs all of its rows, so z goes to the warp's scratch first
// and one lane per SOC block forms the block's scalars, after which the
// lanes project the block's rows through u1 and u2 (Cx'u, Cu'u) once per
// knot. The tiny sequential pieces (Cholesky pivots, the dV sums) run on
// lane 0; the n+1 triangular solves run one column per lane.
//
// What bounds it on the H100: latency of the knot recursion (about 20 warp
// synchronisations per knot and short dot products on shared memory), not
// bytes or FLOPs: at B=1024, N=30, n=12, m=6 it reads ~1 MB and does
// ~10 kFLOP per scenario-knot. An SOC block adds O(p (n + m)) work per knot
// and two more warp synchronisations. B=1024 gives 256 blocks of 4 warps.
#include <cstdint>

#include "common.cuh"

namespace {

// Shared-memory sizes, in elements: the staged knot rows
//   Q[n*n] q[n] R[m*m] r[m] H[m*n] A[n*n] B[n*m] Cx[P*n] Cu[P*m] b[P] mask[P]
// and one scenario's work space
//   x[n] u[m] g[P] w[P] z[P] Vx[n] Vxx[n*n] Qx[n] Qu[m] Qxx[n*n] Quu[m*m]
//   Qux[m*n] VA[n*n] VB[n*m] L[m*m] KD[(n+1)*m] Quud[m] QuuK[m*n]
//   and per SOC block soc_elems: its scalars and its rows projected through
//   u1 and u2.
__host__ __device__ inline int knot_elems(int n, int m, int P) {
  return 2 * n * n + n + m * m + m + 2 * m * n + P * (n + m + 2);
}

// polar, gamma, a, a_safe, coef1, coef2, ax1[n], ax2[n], au1[m], au2[m]
constexpr int kSocScalars = 6;
__host__ __device__ inline int soc_elems(int n, int m) {
  return kSocScalars + 2 * (n + m);
}

__host__ __device__ inline int scenario_elems(int n, int m, int P,
                                              int nsoc) {
  return 3 * n + 2 * m + 3 * P + 3 * n * n + 2 * m * m + 3 * m * n +
         (n + 1) * m + m + m * n + nsoc * soc_elems(n, m);
}

template <typename T>
__device__ inline void copy_block(T* dst, const T* __restrict__ src,
                                  int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// z = lam + rho c and the per-row gradient g and curvature weight w; for
// each SOC block also its scalars and its rows projected through u1 and u2
// (only the state part when !with_u). Ends with the warp synchronised.
template <typename T>
__device__ inline void row_terms(const altro::BlockTable<T>& tab, int P,
                                 int n, int m, bool with_u, const T* sCx,
                                 const T* sCu, const T* sb, const T* smask,
                                 const T* x, const T* u, size_t lane_knot,
                                 T rho, T* z, T* g, T* w, T* soc, int lane) {
  for (int rr = lane; rr < P; rr += 32) {
    const int bi = altro::block_of(tab, rr);
    const int p = tab.p[bi];
    T c = sb[rr];
    for (int i = 0; i < n; ++i) c += sCx[rr * n + i] * x[i];
    if (with_u)
      for (int j = 0; j < m; ++j) c += sCu[rr * m + j] * u[j];
    const T zr = tab.lam[bi][lane_knot * p + (rr - tab.row0[bi])] + rho * c;
    z[rr] = zr;
    const T mk = smask[rr];
    if (tab.cone[bi] == altro::kNonpos) {
      const bool act = zr > T(0);
      // max(z, 0), NaN propagating like jnp.maximum
      g[rr] = (act || zr != zr ? zr : T(0)) * mk;
      w[rr] = rho * (act ? T(1) : T(0)) * mk;
    } else if (tab.cone[bi] == altro::kZero) {
      g[rr] = zr * mk;
      w[rr] = rho * mk;
    }
  }
  __syncwarp();
  if (tab.nsoc == 0) return;
  const int se = soc_elems(n, m);
  // one lane per SOC block: |v|, the case flags and the rank-1 weights
  for (int s = lane; s < tab.nsoc; s += 32) {
    const int bi = tab.soc_block[s];
    const int r0 = tab.row0[bi], p = tab.p[bi];
    T a2 = T(0);
    for (int r = 0; r < p - 1; ++r) a2 += z[r0 + r] * z[r0 + r];
    const T sv = z[r0 + p - 1];
    const T a = sqrt(a2);
    const T a_safe = a > T(0) ? a : T(1);
    // float flags multiplied in, as jnp does: a NaN z stays NaN
    const T polar = a <= -sv ? T(1) : T(0);
    const T bnd = (a > sv && a > -sv) ? T(1) : T(0);
    const T gamma = bnd * (a - sv) / (T(2) * a_safe);
    const T rm = rho * smask[r0];
    T* sc = soc + s * se;
    sc[0] = polar;
    sc[1] = gamma;
    sc[2] = a;
    sc[3] = a_safe;
    sc[4] = -(rm * gamma);
    sc[5] = T(0.5) * (rm * bnd);
  }
  __syncwarp();
  for (int rr = lane; rr < P; rr += 32) {
    const int bi = altro::block_of(tab, rr);
    if (tab.cone[bi] != altro::kSoc) continue;
    const T* sc = soc + tab.slot[bi] * se;
    const T polar = sc[0], gamma = sc[1], mk = smask[rr];
    if (rr < tab.row0[bi] + tab.p[bi] - 1) {
      g[rr] = (polar * z[rr] + gamma * z[rr]) * mk;
      w[rr] = rho * (polar + gamma) * mk;
    } else {
      g[rr] = (polar * z[rr] - gamma * sc[2]) * mk;
      w[rr] = rho * polar * mk;
    }
  }
  // ax1/ax2 = Cx' u1/u2 (and au = Cu' u), u1 = (vh, 0), u2 = (-vh, 1)
  const int width = with_u ? n + m : n;
  for (int e = lane; e < tab.nsoc * width; e += 32) {
    const int s = e / width, i = e % width;
    const int bi = tab.soc_block[s];
    const int r0 = tab.row0[bi], p = tab.p[bi];
    T* sc = soc + s * se;
    const T a_safe = sc[3];
    const bool state = i < n;
    const T* C = state ? sCx + i : sCu + (i - n);
    const int stride = state ? n : m;
    T acc1 = T(0), acc2 = T(0);
    for (int r = 0; r < p; ++r) {
      const T cr = C[(r0 + r) * stride];
      const T vh = r < p - 1 ? z[r0 + r] / a_safe : T(0);
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
  __syncwarp();
}

// sum over SOC blocks of coef1 p1_i q1_j + coef2 p2_i q2_j, where p and q
// are the blocks' projections at offsets oi and oj (0: Cx'u, 2n: Cu'u)
template <typename T>
__device__ inline T rank_terms(const T* soc, int nsoc, int n, int m, int oi,
                               int i, int oj, int j) {
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

template <typename T>
__global__ void fused_expand_backward_kernel(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ rho, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int N, int n, int m, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  T* smem = reinterpret_cast<T*>(smem_raw);
  if (threadIdx.x == 0) tab = table;
  const int spb = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * spb + warp;
  const bool active = b < Bt;
  const int N1 = N - 1;

  T* sQ = smem;
  T* sq = sQ + n * n;
  T* sR = sq + n;
  T* sr = sR + m * m;
  T* sH = sr + m;
  T* sA = sH + m * n;
  T* sB = sA + n * n;
  T* sCx = sB + n * m;
  T* sCu = sCx + P * n;
  T* sb = sCu + P * m;
  T* smask = sb + P;

  T* x = smem + knot_elems(n, m, P) +
         warp * scenario_elems(n, m, P, table.nsoc);
  T* u = x + n;
  T* g = u + m;
  T* w = g + P;
  T* z = w + P;
  T* Vx = z + P;
  T* Vxx = Vx + n;
  T* Qx = Vxx + n * n;
  T* Qu = Qx + n;
  T* Qxx = Qu + m;
  T* Quu = Qxx + n * n;
  T* Qux = Quu + m * m;
  T* VA = Qux + m * n;
  T* VB = VA + n * n;
  T* Lc = VB + n * m;
  T* KD = Lc + m * m;  // column c of the solve at KD[c*m]: K[:, c], d at c=n
  T* Quud = KD + (n + 1) * m;
  T* QuuK = Quud + m;
  T* soc = QuuK + m * n;  // SOC block scalars and projections
  const int nsoc = table.nsoc;

  // ---------------- terminal knot: V = expansion at N-1 with u = 0
  copy_block(sQ, Q + (size_t)N1 * n * n, n * n);
  copy_block(sq, q + (size_t)N1 * n, n);
  copy_block(sCx, Cx + (size_t)N1 * P * n, P * n);
  copy_block(sb, cb + (size_t)N1 * P, P);
  copy_block(smask, cmask + (size_t)N1 * P, P);
  __syncthreads();

  T dv1 = T(0), dv2 = T(0);
  if (active) {
    const T* xk = X + ((size_t)b * N + N1) * n;
    for (int i = lane; i < n; i += 32) x[i] = xk[i];
    __syncwarp();
    row_terms(tab, P, n, m, false, sCx, sCu, sb, smask, x, u,
              (size_t)b * N + N1, rho[(size_t)b * N + N1], z, g, w, soc,
              lane);
    for (int i = lane; i < n; i += 32) {
      T acc = sq[i];
      for (int p = 0; p < n; ++p) acc += sQ[i * n + p] * x[p];
      for (int rr = 0; rr < P; ++rr) acc += sCx[rr * n + i] * g[rr];
      Vx[i] = acc;
    }
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e % n;
      if (j < i) continue;
      T acc = sQ[i * n + j];
      for (int rr = 0; rr < P; ++rr)
        acc += (sCx[rr * n + i] * w[rr]) * sCx[rr * n + j];
      acc += rank_terms(soc, nsoc, n, m, 0, i, 0, j);
      Vxx[i * n + j] = acc;
      Vxx[j * n + i] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---------------- knots N-2 .. 0
  for (int k = N1 - 1; k >= 0; --k) {
    copy_block(sQ, Q + (size_t)k * n * n, n * n);
    copy_block(sq, q + (size_t)k * n, n);
    copy_block(sR, R + (size_t)k * m * m, m * m);
    copy_block(sr, r + (size_t)k * m, m);
    copy_block(sH, H + (size_t)k * m * n, m * n);
    copy_block(sA, A + (size_t)k * n * n, n * n);
    copy_block(sB, Bm + (size_t)k * n * m, n * m);
    copy_block(sCx, Cx + (size_t)k * P * n, P * n);
    copy_block(sCu, Cu + (size_t)k * P * m, P * m);
    copy_block(sb, cb + (size_t)k * P, P);
    copy_block(smask, cmask + (size_t)k * P, P);
    __syncthreads();

    if (active) {
      const T* xk = X + ((size_t)b * N + k) * n;
      const T* uk = U + ((size_t)b * N1 + k) * m;
      for (int i = lane; i < n; i += 32) x[i] = xk[i];
      for (int i = lane; i < m; i += 32) u[i] = uk[i];
      const T regb = reg[b];
      __syncwarp();
      row_terms(tab, P, n, m, true, sCx, sCu, sb, smask, x, u,
                (size_t)b * N + k, rho[(size_t)b * N + k], z, g, w, soc,
                lane);
      for (int e = lane; e < n * n; e += 32) {
        const int i = e / n, j = e % n;
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += Vxx[i * n + p] * sA[p * n + j];
        VA[e] = acc;
      }
      for (int e = lane; e < n * m; e += 32) {
        const int i = e / m, j = e % m;
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += Vxx[i * n + p] * sB[p * m + j];
        VB[e] = acc;
      }
      __syncwarp();

      // Q = l + (dynamics)' V terms
      for (int i = lane; i < n; i += 32) {
        T lx = sq[i];
        for (int p = 0; p < n; ++p) lx += sQ[i * n + p] * x[p];
        for (int j = 0; j < m; ++j) lx += sH[j * n + i] * u[j];
        for (int rr = 0; rr < P; ++rr) lx += sCx[rr * n + i] * g[rr];
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += sA[p * n + i] * Vx[p];
        Qx[i] = lx + acc;
      }
      for (int i = lane; i < m; i += 32) {
        T lu = sr[i];
        for (int p = 0; p < m; ++p) lu += sR[i * m + p] * u[p];
        for (int p = 0; p < n; ++p) lu += sH[i * n + p] * x[p];
        for (int rr = 0; rr < P; ++rr) lu += sCu[rr * m + i] * g[rr];
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += sB[p * m + i] * Vx[p];
        Qu[i] = lu + acc;
      }
      for (int e = lane; e < n * n; e += 32) {
        const int i = e / n, j = e % n;
        const int a = i <= j ? i : j, c = i <= j ? j : i;
        T lxx = sQ[a * n + c];
        for (int rr = 0; rr < P; ++rr)
          lxx += (sCx[rr * n + a] * w[rr]) * sCx[rr * n + c];
        lxx += rank_terms(soc, nsoc, n, m, 0, a, 0, c);
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += sA[p * n + i] * VA[p * n + j];
        Qxx[e] = lxx + acc;
      }
      for (int e = lane; e < m * m; e += 32) {
        const int i = e / m, j = e % m;
        const int a = i <= j ? i : j, c = i <= j ? j : i;
        T luu = sR[a * m + c];
        for (int rr = 0; rr < P; ++rr)
          luu += (sCu[rr * m + a] * w[rr]) * sCu[rr * m + c];
        luu += rank_terms(soc, nsoc, n, m, 2 * n, a, 2 * n, c);
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += sB[p * m + i] * VB[p * m + j];
        Quu[e] = luu + acc;
      }
      for (int e = lane; e < m * n; e += 32) {
        const int i = e / n, j = e % n;
        T lux = sH[i * n + j];
        for (int rr = 0; rr < P; ++rr)
          lux += (sCu[rr * m + i] * w[rr]) * sCx[rr * n + j];
        lux += rank_terms(soc, nsoc, n, m, 2 * n, i, 0, j);
        T acc = T(0);
        for (int p = 0; p < n; ++p) acc += sB[p * m + i] * VA[p * n + j];
        Qux[e] = lux + acc;
      }
      __syncwarp();

      // Cholesky of Quu + reg I, column by column
      for (int j = 0; j < m; ++j) {
        if (lane == 0) {
          T dg = Quu[j * m + j] + regb;
          for (int p = 0; p < j; ++p) dg -= Lc[j * m + p] * Lc[j * m + p];
          Lc[j * m + j] = sqrt(fmax(dg, T(1e-12)));
        }
        __syncwarp();
        for (int i = j + 1 + lane; i < m; i += 32) {
          T s = Quu[i * m + j];
          for (int p = 0; p < j; ++p) s -= Lc[i * m + p] * Lc[j * m + p];
          Lc[i * m + j] = s / Lc[j * m + j];
        }
        __syncwarp();
      }
      // (K | d) = -(L L')^-1 (Qux | Qu), one right-hand side per lane
      for (int c = lane; c <= n; c += 32) {
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
      }
      __syncwarp();

      const T* dk = KD + n * m;
      T* Kb = Kout + ((size_t)b * N1 + k) * m * n;
      T* db = dout + ((size_t)b * N1 + k) * m;
      for (int e = lane; e < m * n; e += 32) {
        const int i = e / n, j = e % n;
        Kb[e] = KD[j * m + i];
        T acc = T(0);
        for (int p = 0; p < m; ++p) acc += Quu[i * m + p] * KD[j * m + p];
        QuuK[e] = acc;
      }
      for (int i = lane; i < m; i += 32) {
        db[i] = dk[i];
        T acc = T(0);
        for (int p = 0; p < m; ++p) acc += Quu[i * m + p] * dk[p];
        Quud[i] = acc;
      }
      __syncwarp();

      if (lane == 0) {
        T s1 = T(0), s2 = T(0);
        for (int i = 0; i < m; ++i) {
          s1 += dk[i] * Qu[i];
          s2 += dk[i] * Quud[i];
        }
        dv1 += s1;
        dv2 += T(0.5) * s2;
      }
      // Vx = Qx + K'(Quu d + Qu) + Qux' d
      for (int i = lane; i < n; i += 32) {
        T s1 = T(0), s2 = T(0);
        for (int p = 0; p < m; ++p) {
          s1 += KD[i * m + p] * (Quud[p] + Qu[p]);
          s2 += Qux[p * n + i] * dk[p];
        }
        Vx[i] = Qx[i] + s1 + s2;
      }
      // Vxx = Qxx + K'Quu K + K'Qux + Qux'K, upper triangle mirrored
      for (int e = lane; e < n * n; e += 32) {
        const int i = e / n, j = e % n;
        if (j < i) continue;
        T s1 = T(0), s2 = T(0), s3 = T(0);
        for (int p = 0; p < m; ++p) {
          s1 += KD[i * m + p] * QuuK[p * n + j];
          s2 += KD[i * m + p] * Qux[p * n + j];
          s3 += KD[j * m + p] * Qux[p * n + i];
        }
        const T v = Qxx[i * n + j] + s1 + s2 + s3;
        Vxx[i * n + j] = v;
        Vxx[j * n + i] = v;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  if (active && lane == 0) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
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
  const size_t smem_cap = 232448 - sizeof(table);  // 227 KB opt-in limit
  int spb = 4;
  size_t bytes = 0;
  for (;;) {
    bytes = (size_t)(knot_elems(n, m, P) +
                     spb * scenario_elems(n, m, P, table.nsoc)) *
            sizeof(T);
    if (bytes <= smem_cap || spb == 1) break;
    spb /= 2;
  }
  if (bytes > smem_cap) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024 - sizeof(table)) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_expand_backward_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((Bt + spb - 1) / spb);
  fused_expand_backward_kernel<T>
      <<<blocks, 32 * spb, bytes, (cudaStream_t)stream>>>(
          (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,
          (const T*)A, (const T*)Bm, (const T*)Cx, (const T*)Cu,
          (const T*)cb, (const T*)cmask, table, (const T*)X, (const T*)U,
          (const T*)rho, (const T*)reg, (T*)K, (T*)d, (T*)dV1, (T*)dV2, Bt,
          N, n, m, P);
  return (int)cudaGetLastError();
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
