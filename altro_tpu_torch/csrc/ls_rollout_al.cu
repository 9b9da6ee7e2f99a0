// Closed-loop line-search ladder rollout fused with each rung's AL merit.
//
// Replaces the TPU kernel altro_tpu/ops/rollout.py: batched_ls_rollout_al
// (Pallas body `_make_al_kernel`). For every scenario b and rung l of the
// static step-size ladder alpha it runs kernel A's rollout
//
//   u_k   = ubar_k + alpha_l d_k + K_k (x_k - xbar_k)
//   x_k+1 = A_k x_k + B_k u_k + dd_k,          x_0 = xbar_0
//
// and accumulates the rung's line-search merit along the way:
//
//   J = sum_k<N-1 [1/2 x'Qx + q'x + 1/2 u'Ru + r'u + u'Hx + c + pen(x, u)]
//       + 1/2 x'Qx + q'x + c + pen(x, 0)               (terminal, u = 0)
//   pen = sum_blocks mask |proj_polar(lam + rho c)|^2 / (2 rho)
//   ZERO: z^2;  NONPOS: max(z, 0)^2;
//   SOC:  polar (a^2 + s^2) + 2 gamma^2 a^2   (z = (v, s), a = |v|)
//
// i.e. the AL cost without the rung-independent -|lam|^2/(2 rho) term.
// rho is the first block's penalty schedule [Bt, N], shared by every block
// as the solver keeps it. A, B and dd may come per group of scenarios
// ([G, N-1, ...], Bt / G contiguous scenarios to a group; the cost and the
// blocks stay shared): grid.z runs over the groups and a block's scenarios
// lie in one group, whose rows it stages once for them. Outputs:
// Xs [Bt, L, N, n] (knot 0 = xbar_0), Us [Bt, L, N-1, m], J [Bt, L]. The
// terminal rows of R, r, H and Cu are not read. L <= kMaxRungs, n, m <=
// kMaxDim, at most kMaxRows rows in kMaxBlocks blocks (common.cuh).
//
// Thread mapping (kernel A's, ls_rollout.cu, plus the merit): a group of
// G = 16 lanes (n, m <= 16) or 32 lanes carries one (scenario, rung); lane i
// owns row i of u and of x+, and x, dx, u go round the group by __shfl_sync.
// A block holds S scenarios with their rungs (all L of them while L G <= 512
// threads; longer ladders split into chunks of rungs along grid.y). Each
// knot, the shared rows (Q q c Cx b mask R r H A B dd Cu) are staged once per
// block and a scenario's K_k, d_k, xbar_k, ubar_k, its multipliers' rows and
// rho_k once for its rungs, by cp.async one knot ahead into a double buffer:
// the loads of knot k+1 overlap the arithmetic of knot k; one __syncthreads
// per knot. Where each element of a buffer comes from (its array, its offset
// in the array's knot row, its scenario) is tabulated once per block, so
// staging a knot costs a thread a dozen instructions per element: one copy
// loop per array, with its 64-bit address arithmetic, cost a warp ~580
// instructions per knot, more than the recursion and the merit together.
// Consecutive lanes store consecutive entries of Xs and Us.
//
// The merit is spread over the group and shares the state recursion's
// shuffles: while lane i sums A_i . x it also sums Q_i . x, H_i . x and
// Cx_rr . x for its constraint rows rr = i, i + G, ... (RP rows per lane, a
// compile-time 1, 2 or 4), and likewise R_i . u and Cu_rr . u beside B_i . u.
// Lane i forms x_i (q_i + Q_i.x / 2) + u_i (r_i + R_i.u / 2 + H_i.x) and its
// blocks' penalties, and a butterfly over the group adds the knot's merit to
// the running sum; nothing of x_k+1 depends on them, so the scheduler
// overlaps them with the state chain. A block's
// penalty needs all its rows (an SOC block's |v| above all): each row's
// z^2 (max(z, 0)^2 for NONPOS, 0 for an SOC block's last row) goes through a
// segmented inclusive scan by __shfl_up_sync, segmented by the block table
// (log2 G steps per G rows, a carry between a lane's rows), and the lane
// that holds a block's LAST row ends up with the block's sum beside its own
// z: it forms polar, bnd and gamma as floats, so a NaN stays a NaN. The
// scan and the butterfly over the group's lanes are fixed trees: the sums
// are deterministic, in another order than row by row.
//
// The merit's sums run in double registers for float problems too (the
// rollout stays in T, and J is rounded to T once): a tracking cost's rows
// (x'Qx / 2, q'x, c) cancel to a small remainder, and in floats their
// rounding, at the size of the uncancelled terms, decided the line search
// near convergence. On the rocket's float solves the worst lane stopped 16%
// above the double solve's cost with a float merit and 0.7% with this one,
// in 13% fewer solver iterations, for a third more kernel time (PERF.md).
//
// What bounds it on the H100: at the rocket window (B=1024, L=6, N=21, n=6,
// m=3, 15 rows) it moves ~8.5 MB (Xs 3.1 MB and Us 1.5 MB written, K, the
// multipliers and Xbar read): 2.5 us at 3.35 TB/s, against ~0.09 GFLOP
// (1.3 us at 67 TFLOP/s f32), so the bytes bound it. What it reaches is set
// by instruction throughput: the ~23 warps per SM that the 6,144 groups of 16
// lanes give hide the knot chain's latency (one barrier, 2n + m dependent
// shuffle-FMA steps, log2 G scan steps), and every instruction of the knot's
// body then counts (PERF.md, kernel table).
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"

namespace {

template <typename T>
struct Ladder {
  T a[altro::kMaxRungs];
};

constexpr unsigned kFull = 0xffffffffu;
// Most threads of a block (the kernel's launch bound): a block is filled to
// it with whole scenarios, which share the staging of the shared rows, while
// the grid keeps two blocks per SM.
constexpr int kMaxThreads = 512;
// Staged arrays: 13 shared stacks, 4 per scenario, its blocks' multipliers
// and rho.
constexpr int kSharedSegs = 13;
constexpr int kScenSegs = 4;
constexpr int kMaxSegs = kSharedSegs + kScenSegs + altro::kMaxBlocks + 1;

// One knot's shared rows, in elements:
//   Q[n*n] q[n] c[1] Cx[P*n] b[P] mask[P] | R[m*m] r[m] H[m*n] A[n*n] B[n*m]
//   dd[n] Cu[P*m]          (the second half is not staged at the terminal)
__host__ __device__ inline int knot_elems(int n, int m, int P) {
  return 2 * n * n + 2 * n + m * m + m + 2 * m * n + 1 + P * (n + m + 2);
}

// One scenario's rows per knot: K[m*n] d[m] xbar[n] ubar[m] lam[P] rho[1].
__host__ __device__ inline int scen_elems(int n, int m, int P) {
  return m * n + 2 * m + n + P + 1;
}

template <typename T, int G, int RP>
__global__ void __launch_bounds__(kMaxThreads) ls_rollout_al_kernel(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ cc,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ dd, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ Xbar, const T* __restrict__ Ubar,
    const T* __restrict__ K, const T* __restrict__ d,
    const T* __restrict__ rho, Ladder<T> ladder, int L, int LC, int S,
    T* __restrict__ Xs, T* __restrict__ Us, T* __restrict__ Jout, int Bt,
    int N, int n, int m, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  __shared__ const T* seg_base[kMaxSegs];
  __shared__ int seg_knot[kMaxSegs], seg_scen[kMaxSegs];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int N1 = N - 1;
  const int tid = threadIdx.x;
  const int lane = tid % G;
  const int grp = tid / G;
  const int l = blockIdx.y * LC + grp % LC;
  const bool in_block = grp / LC < S;  // the last warp may hold padding
  const int s = in_block ? grp / LC : 0;
  // grid.z: the group of scenarios whose dynamics the block reads (one
  // group of Bt when they are shared); no block straddles two groups
  const int reps = Bt / (int)gridDim.z;
  const int bg = blockIdx.x * S;  // the block's first scenario in the group
  const int b0 = (int)blockIdx.z * reps + bg;
  const int b = b0 + s;
  const bool active = in_block && bg + s < reps && l < L;
  const int nscen = min(S, reps - bg);
  A += (size_t)blockIdx.z * N1 * n * n;
  Bm += (size_t)blockIdx.z * N1 * n * m;
  dd += (size_t)blockIdx.z * N1 * n;

  if (tid == 0) tab = table;
  __syncthreads();

  // the lane's constraint rows rr = lane + j G: where each sits in its block
  int rrc[RP], reach[RP], cone[RP];
  bool valid[RP], cont[RP], last[RP];
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    const int rr = lane + j * G;
    valid[j] = rr < P;
    rrc[j] = valid[j] ? rr : 0;  // rows past P compute a copy of row 0
    const int bi = valid[j] ? altro::block_of(tab, rr) : 0;
    const int off = rr - tab.row0[bi];
    cone[j] = valid[j] ? tab.cone[bi] : altro::kZero;
    reach[j] = valid[j] ? min(off, lane) : 0;  // scan steps inside the block
    cont[j] = valid[j] && off > lane;  // the block began on an earlier row j
    last[j] = valid[j] && off == tab.p[bi] - 1;
  }

  const int mn = m * n;
  const int sw = knot_elems(n, m, P);
  const int scen = scen_elems(n, m, P);
  const int buf = sw + S * scen;
  const int o_d = mn, o_xb = mn + m, o_ub = o_xb + n, o_lam = o_ub + m;
  const int o_rho = o_lam + P;

  // The staged arrays, in the buffer's order: the 13 shared stacks, then a
  // scenario's K d xbar ubar, its multipliers block by block, and rho. Per
  // array its base, its stride per knot and per scenario, and whether the
  // terminal knot reads it; per element of a buffer, its array, its offset in
  // the array's knot row and its scenario, tabulated once, so that staging a
  // knot costs a dozen instructions per element and no division.
  if (tid == 0) {
    const int count = kSharedSegs + kScenSegs + tab.count + 1;
    const T* bases[kSharedSegs + kScenSegs] = {
        Q, q, cc, Cx, cb, cmask, R, r, H, A, Bm, dd, Cu, K, d, Xbar, Ubar};
    const int knot[kSharedSegs + kScenSegs] = {
        n * n, n, 1, P * n, P, P, m * m, m, mn, n * n, n * m, n, P * m,
        mn,    m, n, m};
    const int scn[kScenSegs] = {N1 * mn, N1 * m, N * n, N1 * m};
#pragma unroll
    for (int a = 0; a < kSharedSegs + kScenSegs; ++a) {
      seg_base[a] = bases[a];
      seg_knot[a] = knot[a];
      seg_scen[a] = a < kSharedSegs ? 0 : scn[a - kSharedSegs];
    }
    for (int bi = 0; bi < tab.count; ++bi) {
      seg_base[kSharedSegs + kScenSegs + bi] = tab.lam[bi];
      seg_knot[kSharedSegs + kScenSegs + bi] = tab.p[bi];
      seg_scen[kSharedSegs + kScenSegs + bi] = N * tab.p[bi];
    }
    seg_base[count - 1] = rho;
    seg_knot[count - 1] = 1;
    seg_scen[count - 1] = N;
  }
  __syncthreads();
  int* codes = reinterpret_cast<int*>(smem + 2 * buf);
  for (int e = tid; e < buf; e += blockDim.x) {
    // code = scenario << 24 | array << 16 | offset in the array's knot row
    int a = 0, off = e, si = 0;
    if (e >= sw) {
      si = (e - sw) / scen;
      off = (e - sw) % scen;
      a = kSharedSegs;
    }
    while (off >= seg_knot[a]) off -= seg_knot[a++];
    codes[e] = si << 24 | a << 16 | off;
  }
  __syncthreads();
  // the arrays the terminal knot does not read: R r H A B dd Cu, K d xbar
  // ubar
  constexpr unsigned kNoTerm = ((1u << 11) - 1) << 6;

  // knot k's rows into dst: coalesced, one element per thread and step
  auto stage = [&](int k, T* dst) {
    const bool term = k == N1;
#pragma unroll 1
    for (int e = tid; e < sw + nscen * scen; e += blockDim.x) {
      const int code = codes[e];
      const int a = (code >> 16) & 255;
      if (term && a < 32 && (kNoTerm >> a & 1)) continue;
      const size_t at = (size_t)(b0 + (code >> 24)) * seg_scen[a] +
                        (size_t)k * seg_knot[a] + (code & 0xffff);
      altro::cp_async(dst + e, seg_base[a] + at);
    }
  };

  // the rung's step size, selected without indexing the parameter array
  // (a dynamic index would copy it to the stack)
  T alpha = T(0);
#pragma unroll
  for (int i = 0; i < altro::kMaxRungs; ++i)
    if (i == l) alpha = ladder.a[i];
  const int xi = lane < n ? lane : 0;  // lanes past n or m compute a copy
  const int ui = lane < m ? lane : 0;  // of row 0 and store nothing
  T* Xo = Xs + ((size_t)b * L + l) * N * n;
  T* Uo = Us + ((size_t)b * L + l) * N1 * m;
  T x = T(0);
  if (active) {
    x = Xbar[(size_t)b * N * n + xi];
    if (lane < n) Xo[lane] = x;
  }
  double J = 0.0;

  stage(0, smem);
  altro::cp_async_commit();
  for (int k = 0; k <= N1; ++k) {
    // knot k has landed, and every thread is past knot k-1, whose buffer
    // the prefetch of knot k+1 now takes
    altro::cp_async_wait_all();
    __syncthreads();
    if (k < N1) {
      stage(k + 1, smem + ((k + 1) & 1) * buf);
      altro::cp_async_commit();
    }
    const bool term = k == N1;
    const T* sQ = smem + (k & 1) * buf;
    const T* sq = sQ + n * n;
    const T* sc0 = sq + n;
    const T* sCx = sc0 + 1;
    const T* sb = sCx + P * n;
    const T* smask = sb + P;
    const T* sR = smask + P;
    const T* sr = sR + m * m;
    const T* sH = sr + m;
    const T* sA = sH + mn;
    const T* sB = sA + n * n;
    const T* sdd = sB + n * m;
    const T* sCu = sdd + n;
    const T* sc = sQ + sw + s * scen;

    // u = (ubar + alpha d) + K dx; u = 0 at the terminal knot
    T u = T(0);
    if (!term) {
      const T dx = x - sc[o_xb + xi];
      T kd = T(0);
#pragma unroll 2
      for (int p = 0; p < n; ++p)
        kd += sc[ui * n + p] * __shfl_sync(kFull, dx, p, G);
      u = (sc[o_ub + ui] + alpha * sc[o_d + ui]) + kd;
    }
    // one round of x: A_i.x for x+, Q_i.x and H_i.x for the cost, Cx_rr.x
    // for the lane's constraint rows
    // (the merit's sums in doubles: see the header)
    T acc = T(0);
    double qx = 0.0, hx = 0.0, c[RP];
#pragma unroll
    for (int j = 0; j < RP; ++j) c[j] = 0.0;
#pragma unroll 2
    for (int p = 0; p < n; ++p) {
      const T xp = __shfl_sync(kFull, x, p, G);
      const double xd = (double)xp;
      acc += sA[xi * n + p] * xp;
      qx += (double)sQ[xi * n + p] * xd;
      hx += (double)sH[ui * n + p] * xd;
#pragma unroll
      for (int j = 0; j < RP; ++j) c[j] += (double)sCx[rrc[j] * n + p] * xd;
    }
    // one round of u: B_i.u, R_i.u, Cu_rr.u
    double ru = 0.0;
    if (!term) {
#pragma unroll 2
      for (int p = 0; p < m; ++p) {
        const T up = __shfl_sync(kFull, u, p, G);
        const double ud = (double)up;
        acc += sB[xi * m + p] * up;
        ru += (double)sR[ui * m + p] * ud;
#pragma unroll
        for (int j = 0; j < RP; ++j) c[j] += (double)sCu[rrc[j] * m + p] * ud;
      }
    }

    // the lane's rows of the cost
    double jj = lane == 0 ? (double)sc0[0] : 0.0;
    if (lane < n) jj += (double)x * ((double)sq[xi] + 0.5 * qx);
    if (!term && lane < m)
      jj += (double)u * (((double)sr[ui] + 0.5 * ru) + hx);

    // the blocks' penalties: a segmented scan of the rows' squares, closed
    // on the lane of each block's last row
    const double rk = (double)sc[o_rho];
    const double inv2rho = 0.5 / rk;
    double carry = 0.0;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      if (j * G < P) {
        const double z = (double)sc[o_lam + rrc[j]] +
                         rk * (c[j] + (double)sb[rrc[j]]);
        double v = z * z;
        // max(z, 0), NaN propagating like jnp.maximum
        if (cone[j] == altro::kNonpos && !(z > 0.0) && z == z) v = 0.0;
        if (!valid[j] || (cone[j] == altro::kSoc && last[j])) v = 0.0;
#pragma unroll
        for (int dl = 1; dl < G; dl <<= 1) {
          const double t = __shfl_up_sync(kFull, v, dl, G);
          if (dl <= reach[j]) v += t;
        }
        if (cont[j]) v += carry;
        if (j + 1 < RP) carry = __shfl_sync(kFull, v, G - 1, G);
        // an SOC block: v = |v|^2 of its first p - 1 rows, z its last row;
        // float flags multiplied in, as jnp does: a NaN z stays NaN
        const double a = sqrt(v);
        const double a_safe = a > 0.0 ? a : 1.0;
        const double polar = a <= -z ? 1.0 : 0.0;
        const double bnd = (a > z && a > -z) ? 1.0 : 0.0;
        const double gamma = bnd * (a - z) / (2.0 * a_safe);
        const double soc = polar * (v + z * z) + ((2.0 * gamma) * gamma) * v;
        const double ssq = cone[j] == altro::kSoc ? soc : v;
        if (last[j]) jj += ((double)smask[rrc[j]] * inv2rho) * ssq;
      }
    }
    // the knot's merit, summed over the group by a fixed butterfly, before it
    // joins the running sum (the cost's rows cancel within the knot)
#pragma unroll
    for (int dl = G / 2; dl > 0; dl >>= 1)
      jj += __shfl_xor_sync(kFull, jj, dl, G);
    J += jj;

    if (!term) {
      // x+ = (A x + B u) + dd
      x = acc + sdd[xi];
      if (active) {
        if (lane < m) Uo[(size_t)k * m + lane] = u;
        if (lane < n) Xo[(size_t)(k + 1) * n + lane] = x;
      }
    }
  }

  if (active && lane == 0) Jout[(size_t)b * L + l] = (T)J;
}

// The wide body, for n or m above kNarrowDim (up to kMaxDim): a block of
// kWideThreads = kMaxDim threads per (scenario, rung) on grid (Bt, L),
// thread i owning row i of u and of x+ and constraint row i (kMaxRows =
// kMaxDim), with x, dx and u exchanged through shared memory; the rows are
// read from device memory. The merit's sums run in doubles as in the group
// body: each thread's cost rows, one thread per block for its penalty (the
// rows' squares summed in row order), then the knot's sum over the block by
// two warp butterflies and their sum, before it joins the running sum.
// Bound at n = m = 64, B = 1024, L = 11: the FLOPs (0.18 ms); it reaches
// ~24 ms, kernel A's wide body's reads (the cost rows too) plus the
// merit's double-precision sums (PERF.md).
constexpr int kWideThreads = altro::kMaxDim;
static_assert(altro::kMaxRows <= kWideThreads, "a thread per row");

template <typename T>
__global__ void __launch_bounds__(kWideThreads) ls_rollout_al_wide(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ cc,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ dd, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ Xbar, const T* __restrict__ Ubar,
    const T* __restrict__ K, const T* __restrict__ d,
    const T* __restrict__ rho, Ladder<T> ladder, int L,
    T* __restrict__ Xs, T* __restrict__ Us, T* __restrict__ Jout, int Bt,
    int NG, int N, int n, int m, int P) {
  __shared__ altro::BlockTable<T> tab;
  __shared__ T xs[altro::kMaxDim], dxs[altro::kMaxDim], us[altro::kMaxDim];
  __shared__ double zs[altro::kMaxRows], vs[altro::kMaxRows];
  __shared__ double red[kWideThreads / 32];
  const int b = blockIdx.x, l = blockIdx.y, t = threadIdx.x, N1 = N - 1;
  // the scenario's group of NG (NG = 1: shared dynamics)
  const size_t grp = (size_t)(b / (Bt / NG));
  A += grp * N1 * n * n;
  Bm += grp * N1 * n * m;
  dd += grp * N1 * n;
  if (t == 0) tab = table;
  T alpha = T(0);
#pragma unroll
  for (int i = 0; i < altro::kMaxRungs; ++i)
    if (i == l) alpha = ladder.a[i];
  T* Xo = Xs + ((size_t)b * L + l) * N * n;
  T* Uo = Us + ((size_t)b * L + l) * N1 * m;
  const T* xb = Xbar + (size_t)b * N * n;
  if (t < n) {
    xs[t] = xb[t];
    Xo[t] = xb[t];
  }
  double J = 0.0;
  for (int k = 0; k <= N1; ++k) {
    const bool term = k == N1;
    if (t < n) dxs[t] = term ? T(0) : xs[t] - xb[(size_t)k * n + t];
    __syncthreads();
    // u = (ubar + alpha d) + K dx; u = 0 at the terminal knot
    if (t < m) {
      T u = T(0);
      if (!term) {
        const size_t ku = (size_t)b * N1 + k;
        const T* Kr = K + (ku * m + t) * n;
        T kd = T(0);
        for (int p = 0; p < n; ++p) kd += Kr[p] * dxs[p];
        u = (Ubar[ku * m + t] + alpha * d[ku * m + t]) + kd;
        Uo[(size_t)k * m + t] = u;
      }
      us[t] = u;
    }
    __syncthreads();
    // the thread's rows of the cost
    double jj = t == 0 ? (double)cc[k] : 0.0;
    if (t < n) {
      const T* Qr = Q + ((size_t)k * n + t) * n;
      double qx = 0.0;
      for (int p = 0; p < n; ++p) qx += (double)Qr[p] * (double)xs[p];
      jj += (double)xs[t] * ((double)q[(size_t)k * n + t] + 0.5 * qx);
    }
    if (!term && t < m) {
      const T* Rr = R + ((size_t)k * m + t) * m;
      const T* Hr = H + ((size_t)k * m + t) * n;
      double ru = 0.0, hx = 0.0;
      for (int p = 0; p < m; ++p) ru += (double)Rr[p] * (double)us[p];
      for (int p = 0; p < n; ++p) hx += (double)Hr[p] * (double)xs[p];
      jj += (double)us[t] * (((double)r[(size_t)k * m + t] + 0.5 * ru) + hx);
    }
    // the constraint row's z and its square (max(z, 0)^2 for NONPOS, NaN
    // propagating like jnp.maximum; 0 for an SOC block's last row)
    const double rk = (double)rho[(size_t)b * N + k];
    if (t < P) {
      const T* Cxr = Cx + ((size_t)k * P + t) * n;
      double c = 0.0;
      for (int p = 0; p < n; ++p) c += (double)Cxr[p] * (double)xs[p];
      if (!term) {
        const T* Cur = Cu + ((size_t)k * P + t) * m;
        for (int p = 0; p < m; ++p) c += (double)Cur[p] * (double)us[p];
      }
      const int bi = altro::block_of(tab, t);
      const int off = t - tab.row0[bi];
      const double z =
          (double)tab.lam[bi][((size_t)b * N + k) * tab.p[bi] + off] +
          rk * (c + (double)cb[(size_t)k * P + t]);
      double v = z * z;
      if (tab.cone[bi] == altro::kNonpos && !(z > 0.0) && z == z) v = 0.0;
      if (tab.cone[bi] == altro::kSoc && off == tab.p[bi] - 1) v = 0.0;
      zs[t] = z;
      vs[t] = v;
    }
    // x+ = (A x + B u) + dd
    T xn = T(0);
    if (!term && t < n) {
      const size_t kd = (size_t)k;
      const T* Ar = A + (kd * n + t) * n;
      const T* Br = Bm + (kd * n + t) * m;
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += Ar[p] * xs[p];
      for (int p = 0; p < m; ++p) acc += Br[p] * us[p];
      xn = acc + dd[kd * n + t];
    }
    __syncthreads();
    // one thread per block: its penalty; an SOC block's |v|^2 and its last
    // row's z, float flags multiplied in as jnp does (a NaN z stays NaN)
    if (t < tab.count) {
      const int r0 = tab.row0[t], p = tab.p[t];
      double v = 0.0;
      for (int i = 0; i < p; ++i) v += vs[r0 + i];
      const double z = zs[r0 + p - 1];
      const double a = sqrt(v);
      const double a_safe = a > 0.0 ? a : 1.0;
      const double polar = a <= -z ? 1.0 : 0.0;
      const double bnd = (a > z && a > -z) ? 1.0 : 0.0;
      const double gamma = bnd * (a - z) / (2.0 * a_safe);
      const double soc = polar * (v + z * z) + ((2.0 * gamma) * gamma) * v;
      const double ssq = tab.cone[t] == altro::kSoc ? soc : v;
      jj += ((double)cmask[(size_t)k * P + r0 + p - 1] * (0.5 / rk)) * ssq;
    }
#pragma unroll
    for (int dl = 16; dl > 0; dl >>= 1) jj += __shfl_xor_sync(kFull, jj, dl);
    if (t % 32 == 0) red[t / 32] = jj;
    __syncthreads();
    if (t == 0) {
      double knot = 0.0;
#pragma unroll
      for (int w = 0; w < kWideThreads / 32; ++w) knot += red[w];
      J += knot;
    }
    if (!term && t < n) {
      xs[t] = xn;
      Xo[(size_t)(k + 1) * n + t] = xn;
    }
  }
  if (t == 0) Jout[(size_t)b * L + l] = (T)J;
}

template <typename T>
struct Args {
  const T *Q, *q, *R, *r, *H, *c, *A, *Bm, *dd, *Cx, *Cu, *cb, *cmask;
  const T *Xbar, *Ubar, *K, *d, *rho;
  T *Xs, *Us, *J;
  int L, Bt, NG, N, n, m, P;  // NG groups of Bt / NG scenarios
};

template <typename T, int G, int RP>
int launch_group(const Args<T>& a, const altro::BlockTable<T>& table,
                 const Ladder<T>& ladder, cudaStream_t stream) {
  auto kern = ls_rollout_al_kernel<T, G, RP>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  const size_t cap = 232448 - attr.sharedSizeBytes;  // 227 KB opt-in limit
  // rungs per block: the whole ladder while it fits the launch bound
  const int LC = std::min(a.L, kMaxThreads / G);
  const int chunks = (a.L + LC - 1) / LC;
  // scenarios per block: up to kMaxThreads, fewer while that leaves under
  // two blocks per SM (264 on the H100's 132) or overflows shared memory
  const int per = LC * G;
  const int reps = a.Bt / a.NG;
  int S = std::max(
      1, std::min({kMaxThreads / per, (a.Bt + 263) / 264, reps}));
  size_t bytes = 0;
  for (;;) {
    // two buffers and the table of their elements' sources
    bytes = (size_t)(knot_elems(a.n, a.m, a.P) +
                     S * scen_elems(a.n, a.m, a.P)) *
            (2 * sizeof(T) + sizeof(int));
    if (bytes <= cap || S == 1) break;
    --S;
  }
  if (bytes > cap) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024 - attr.sharedSizeBytes) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (S * per + 31) / 32 * 32;
  const dim3 grid((unsigned)((reps + S - 1) / S), (unsigned)chunks,
                  (unsigned)a.NG);
  kern<<<grid, threads, bytes, stream>>>(
      a.Q, a.q, a.R, a.r, a.H, a.c, a.A, a.Bm, a.dd, a.Cx, a.Cu, a.cb,
      a.cmask, table, a.Xbar, a.Ubar, a.K, a.d, a.rho, ladder, a.L, LC, S,
      a.Xs, a.Us, a.J, a.Bt, a.N, a.n, a.m, a.P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ls_rollout_al(const void* Q, const void* q, const void* R,
                         const void* r, const void* H, const void* c,
                         const void* A, const void* Bm, const void* dd,
                         const void* Cx, const void* Cu, const void* cb,
                         const void* cmask, int nblocks, const int* meta,
                         const void* const* lams, const void* Xbar,
                         const void* Ubar, const void* K, const void* d,
                         const void* rho, const double* alphas, int L,
                         void* Xs, void* Us, void* J, int Bt, int NG, int N,
                         int n, int m, int P, void* stream) {
  if (L < 1 || L > altro::kMaxRungs || n < 1 || m < 1 ||
      n > altro::kMaxDim || m > altro::kMaxDim || P < 0 ||
      P > altro::kMaxRows || N < 2 || Bt < 1 || NG < 1 || Bt % NG != 0 ||
      NG > 65535)
    return (int)cudaErrorInvalidValue;
  altro::BlockTable<T> table;
  if (!altro::make_table(nblocks, meta, lams, P, &table))
    return (int)cudaErrorInvalidValue;
  Ladder<T> ladder;
  for (int i = 0; i < altro::kMaxRungs; ++i)
    ladder.a[i] = i < L ? (T)alphas[i] : T(0);
  const Args<T> a = {
      (const T*)Q,    (const T*)q,    (const T*)R,  (const T*)r,
      (const T*)H,    (const T*)c,    (const T*)A,  (const T*)Bm,
      (const T*)dd,   (const T*)Cx,   (const T*)Cu, (const T*)cb,
      (const T*)cmask, (const T*)Xbar, (const T*)Ubar, (const T*)K,
      (const T*)d,    (const T*)rho,  (T*)Xs,       (T*)Us,
      (T*)J,          L,              Bt,           NG,
      N,              n,              m,            P};
  cudaStream_t s = (cudaStream_t)stream;
  if (n > altro::kNarrowDim || m > altro::kNarrowDim) {
    ls_rollout_al_wide<T><<<dim3((unsigned)Bt, (unsigned)L), kWideThreads, 0,
                            s>>>(
        a.Q, a.q, a.R, a.r, a.H, a.c, a.A, a.Bm, a.dd, a.Cx, a.Cu, a.cb,
        a.cmask, table, a.Xbar, a.Ubar, a.K, a.d, a.rho, ladder, a.L, a.Xs,
        a.Us, a.J, a.Bt, a.NG, a.N, a.n, a.m, a.P);
    return (int)cudaGetLastError();
  }
  // 16 lanes per (scenario, rung) up to n, m = 16, 32 above; the lane's
  // constraint rows (P / G, rounded up to 1, 2 or 4) as a constant
  if (n <= 16 && m <= 16) {
    if (P <= 16) return launch_group<T, 16, 1>(a, table, ladder, s);
    if (P <= 32) return launch_group<T, 16, 2>(a, table, ladder, s);
    return launch_group<T, 16, 4>(a, table, ladder, s);
  }
  if (P <= 32) return launch_group<T, 32, 1>(a, table, ladder, s);
  return launch_group<T, 32, 2>(a, table, ladder, s);
}

}  // namespace

#define ALTRO_LSAL_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                       \
      const void* Q, const void* q, const void* R, const void* r,            \
      const void* H, const void* c, const void* A, const void* Bm,           \
      const void* dd, const void* Cx, const void* Cu, const void* cb,        \
      const void* cmask, int nblocks, const int* meta,                       \
      const void* const* lams, const void* Xbar, const void* Ubar,           \
      const void* K, const void* d, const void* rho, const double* alphas,   \
      int L, void* Xs, void* Us, void* J, int Bt, int NG, int N, int n,      \
      int m, int P, void* stream) {                                          \
    return launch_ls_rollout_al<T>(Q, q, R, r, H, c, A, Bm, dd, Cx, Cu, cb,  \
                                   cmask, nblocks, meta, lams, Xbar, Ubar,   \
                                   K, d, rho, alphas, L, Xs, Us, J, Bt, NG,  \
                                   N, n, m, P, stream);                      \
  }

ALTRO_LSAL_ENTRY(altro_ls_rollout_al_f32, float)
ALTRO_LSAL_ENTRY(altro_ls_rollout_al_f64, double)
