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
#include "wide.cuh"

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

// The wide bodies, for n or m above kNarrowDim (up to kMaxDim); they
// replace the TPU kernel altro_tpu/ops/rollout.py: batched_ls_rollout_al
// at those widths. As kernel A's wide launcher does (ls_rollout.cu:
// launch_wide), the launcher cuts a scenario's ladder into chunks of Lc
// rungs along grid.y, as many as it takes to give every SM a block, and
// picks the body by Lc.
//
// The ladder body (Lc >= kLadderRungs) is kernel A's ladder body
// (ls_rollout.cu: ls_rollout_wide) with each rung's merit: one block
// carries a chunk of a scenario's ladder, and the rungs are the columns of
// tiled products per knot,
//
//   U_k     = ubar_k 1' + d_k alpha' + K_k (X_k - xbar_k 1')  [m x Lc]
//   X_{k+1} = A_k X_k + B_k U_k + dd_k 1'                     [n x Lc]
//   Q X_k [n x Lc], H X_k and R U_k [m x Lc], Cx X_k + Cu U_k [P x Lc]
//
// each as 4 rows x 2 rungs per pair of threads, which take alternate
// 4-steps of the inner dimension (one 4-vector of each row and of each
// rung's column per step) and add their sums by a shuffle. The merit's
// products are summed in double whatever T, as in the group body (a
// tracking cost's rows cancel to a small remainder): each tile's thread
// adds its Q rows' x_i (q_i + (Q x)_i / 2), or its control rows'
// u_i (r_i + (R u)_i / 2 + (H x)_i), and each constraint row gives its
// z = lam + rho (Cx x + Cu u + b) and its square (max(z, 0)^2 for NONPOS,
// 0 for an SOC block's last row). During the next knot's U product one
// warp per rung adds the knot's terms in a fixed order (the tiles' sums
// lane by lane, each block's penalty, the SOC cases as the group body
// forms them, on the lane of its number, then a butterfly) to the rung's
// J, kept in double across knots and rounded once.
//
// A knot's rows come into shared memory by cp.async (16-byte copies when
// the widths allow), neighbouring threads on neighbouring addresses, each
// read once per block: the scenario's K_k, d_k, ubar_k, xbar_k issued once
// the U product has read knot k-1's, so they land during the second
// product; the knot's A_k, B_k, dd_k (shared, or the group's) and its cost
// and constraint rows (Q q c H R r, Cx Cu b mask) with the scenario's
// multipliers and rho issued at the knot's start, landing during the U
// product. Where these do not fit beside each other (float64 at
// n = m = 64), or where their sharing one place lets two blocks onto an SM
// instead of one (float32 at 64 x 64 with a grid of more blocks than SMs:
// `alias`), the cost and constraint rows take the dynamics rows' place
// once X_{k+1} is formed, one more barrier and wait per knot.
// Rows are padded as row_ld pads them, and the padding holds zeros.
//
// What bounds it on the H100: at n = m = 64, B = 1024, L = 11, N = 21 the
// FLOPs (~12 GFLOP, 0.18 ms at 67 TFLOP/s in float32) against ~0.5 GB of
// bytes (0.14 ms). It reaches 2.44 ms there (PERF.md; H100 80GB HBM3,
// 700 W), set by the two barriers and the products' chains per knot with
// one or two blocks to an SM, and by the knot's shared rows, which every
// block streams from L2 into shared memory once per knot (~110 KB in
// float32 at 64 x 64: ~2.4 GB in all at B = 1024).
//
// The rung body (Lc < kLadderRungs: one lane, or a one-rung chunk): the
// first wide body, a block of kRungThreads threads per (scenario, rung) on
// grid (Bt, L), thread i owning row i of u and of x+ and constraint row i
// (kMaxRows = kMaxDim), with x, dx and u exchanged through shared memory;
// the rows are read from device memory. The merit's sums run in doubles as
// in the group body: each thread's cost rows, one thread per block for its
// penalty (the rows' squares summed in row order), then the knot's sum over
// the block by two warp butterflies and their sum, before it joins the
// running sum. A chunk of few rungs leaves the ladder body's tiles half
// empty and its staging without reuse, and at one lane the rung body's L
// blocks spread the ladder over L SMs.
constexpr int kRollThreads = 256;
constexpr int kRollBlocks = 2;  // the ladder body's blocks per SM, at most
constexpr int kLadderRungs = 4;
constexpr int kRungThreads = altro::kMaxDim;
static_assert(altro::kMaxRows <= kRungThreads, "a thread per row");

// Row stride for rows of w elements: a multiple of 4 elements (two for
// float64) and an odd number of 16-byte pieces (ls_rollout.cu: row_ld).
__host__ __device__ inline int row_ld(int w, int elem) {
  const int v = 16 / elem;
  const int ld = altro::wide::pad4(w);
  return (ld / v) % 2 == 0 ? ld + v : ld;
}

// Offsets of the ladder body's shared memory, in elements of T: the
// scenario's stage (K [m x ldx], d, ubar, xbar), the dynamics rows (A
// [n x ldx], B [n x ldu], dd), the cost and constraint rows (Q [n x ldx],
// q, c, H [m x ldx], R [m x ldu], r, Cx [P x ldx], Cu [P x ldu], b, mask,
// the multipliers, rho; in the dynamics rows' place with `alias`), two
// states [Lc x ldx], the controls [Lc x ldu] and the chunk's step sizes;
// then in doubles: J [Lc], the tiles' cost sums [Lc x (gq + gu)], the
// rows' z and squares [Lc x P] each, mask / (2 rho) [P] and c.
struct AlLayout {
  int ldx, ldu, gq, gu, gc;
  int od, oub, oxb, dyn, oB, odd, cost, oq, oc, oH, oR, orr, oCx, oCu, ob,
      omask, olam, orho, X, xst, U, alpha, total;
  int dJ, dsum, dz, dv, dw, dc, dtotal;
  __host__ __device__ AlLayout(int n, int m, int P, int Lc, int elem,
                               int alias) {
    using altro::wide::pad4;
    ldx = row_ld(n, elem);
    ldu = row_ld(m, elem);
    gq = (n + 3) / 4;
    gu = (m + 3) / 4;
    gc = (P + 3) / 4;
    od = pad4(m * ldx);
    oub = od + pad4(m);
    oxb = oub + pad4(m);
    dyn = oxb + pad4(n);
    oB = dyn + pad4(n * ldx);
    odd = oB + pad4(n * ldu);
    cost = alias ? dyn : odd + pad4(n);
    oq = cost + pad4(n * ldx);
    oc = oq + pad4(n);
    oH = oc + 4;
    oR = oH + pad4(m * ldx);
    orr = oR + pad4(m * ldu);
    oCx = orr + pad4(m);
    oCu = oCx + pad4(P * ldx);
    ob = oCu + pad4(P * ldu);
    omask = ob + pad4(P);
    olam = omask + pad4(P);
    orho = olam + pad4(P);
    const int rows_end = orho + 4;
    X = rows_end > odd + pad4(n) ? rows_end : odd + pad4(n);
    xst = pad4(Lc * ldx);
    U = X + 2 * xst;
    alpha = U + pad4(Lc * ldu);
    total = alpha + altro::kMaxRungs;
    dJ = 0;
    dsum = dJ + Lc;
    dz = dsum + Lc * (gq + gu);
    dv = dz + Lc * P;
    dw = dv + Lc * P;
    dc = dw + P;
    dtotal = dc + 1;
  }
  __host__ __device__ size_t bytes(int elem) const {
    return (size_t)total * elem + (size_t)dtotal * sizeof(double);
  }
};

// acc[r][c] += row i0 + r (clamped to rows - 1) of M [. x ld] dot rung
// (la, lb)[c]'s row of V [. x ldv] (minus the row vsub with kSub; not read
// without), over the width w; the pair's thread `part` takes every other
// 4-step.
template <typename S, bool kSub, typename T>
__device__ __forceinline__ void rows_by_rungs(S (&acc)[4][2], const T* M,
                                              int ld, int rows, int i0,
                                              const T* V, int ldv, int la,
                                              int lb, int w, const T* vsub,
                                              int part) {
  namespace wd = altro::wide;
  for (int p = 4 * part; p < w; p += 8) {
    T va[4], vb[4];
    wd::ld4(V + la * ldv + p, va);
    wd::ld4(V + lb * ldv + p, vb);
    if constexpr (kSub) {
      T s[4];
      wd::ld4(vsub + p, s);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        va[c] -= s[c];
        vb[c] -= s[c];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      T mr[4];
      wd::ld4(M + min(i0 + r, rows - 1) * ld + p, mr);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][0] += (S)mr[c] * (S)va[c];
        acc[r][1] += (S)mr[c] * (S)vb[c];
      }
    }
  }
}

// The pair's two halves of a tile's sums added, on both threads.
template <typename S>
__device__ __forceinline__ void pair_sum(S (&acc)[4][2]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], 1);
}

template <typename T>
__global__ void __launch_bounds__(kRollThreads, kRollBlocks)
ls_rollout_al_wide(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ cc,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ dd, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ Xbar, const T* __restrict__ Ubar,
    const T* __restrict__ K, const T* __restrict__ d,
    const T* __restrict__ rho, Ladder<T> ladder, int L, int Lc, int vec_n,
    int vec_m, int alias, T* __restrict__ Xs, T* __restrict__ Us,
    T* __restrict__ Jout, int Bt, int NG, int N, int n, int m, int P) {
  namespace wd = altro::wide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  __shared__ int8_t row_blk[altro::kMaxRows];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const AlLayout lo(n, m, P, Lc, (int)sizeof(T), alias);
  double* dsm =
      reinterpret_cast<double*>(smem_raw + (size_t)lo.total * sizeof(T));
  const int t = threadIdx.x, nt = blockDim.x, N1 = N - 1;
  const int b = blockIdx.x, l0 = blockIdx.y * Lc, lc = min(Lc, L - l0);
  const int ldx = lo.ldx, ldu = lo.ldu, gq = lo.gq, gu = lo.gu;
  // the scenario's group's dynamics (NG = 1: shared)
  const size_t grp = (size_t)(b / (Bt / NG));
  A += grp * N1 * n * n;
  Bm += grp * N1 * n * m;
  dd += grp * N1 * n;
  T* al = smem + lo.alpha;

  // zeros everywhere (the rows' padding stays zero, J starts at zero), the
  // block table, each row's block, the chunk's step sizes, and the first
  // state, copied to Xs
  if (t == 0) tab = table;
  for (int e = t; e < lo.total; e += nt) smem[e] = T(0);
  for (int e = t; e < lo.dtotal; e += nt) dsm[e] = 0.0;
  for (int rr = t; rr < P; rr += nt)
    row_blk[rr] = (int8_t)altro::block_of(table, rr);
  __syncthreads();
  if (t < lc) {
    T a = T(0);
#pragma unroll
    for (int i = 0; i < altro::kMaxRungs; ++i)
      if (i == l0 + t) a = ladder.a[i];
    al[t] = a;
  }
  for (int e = t; e < lc * n; e += nt) {
    const int l = e / n, p = e - l * n;
    const T v = Xbar[(size_t)b * N * n + p];
    smem[lo.X + l * ldx + p] = v;
    Xs[((size_t)b * L + l0 + l) * N * n + p] = v;
  }

  // each thread's place in the copies of rows of width n and m
  const int v = 16 / (int)sizeof(T);
  const altro::Spread sp_n(vec_n ? n / v : n, t, nt);
  const altro::Spread sp_m(vec_m ? m / v : m, t, nt);
  const altro::Spread sp_n1(n, t, nt), sp_m1(m, t, nt);  // single rows
  // zeros into the padding of rows that another layout's rows may have
  // covered (alias)
  auto zero_pad = [&](T* M, int rows, int cols, int ld) {
    const int pc = wd::pad4(cols) - cols;
    for (int e = t; e < rows * pc; e += nt)
      M[(e / pc) * ld + cols + e % pc] = T(0);
  };
  auto stage_k = [&](int k) {
    const size_t bk = (size_t)b * N1 + k;
    altro::stage_rows(smem, ldx, K + bk * m * n, m, n, vec_n, sp_n);
    altro::stage_rows(smem + lo.od, 0, d + bk * m, 1, m, false, sp_m1);
    altro::stage_rows(smem + lo.oub, 0, Ubar + bk * m, 1, m, false, sp_m1);
    altro::stage_rows(smem + lo.oxb, 0, Xbar + ((size_t)b * N + k) * n, 1,
                      n, false, sp_n1);
  };
  auto stage_dyn = [&](int k) {
    altro::stage_rows(smem + lo.dyn, ldx, A + (size_t)k * n * n, n, n, vec_n,
                      sp_n);
    altro::stage_rows(smem + lo.oB, ldu, Bm + (size_t)k * n * m, n, m, vec_m,
                      sp_m);
    altro::stage_rows(smem + lo.odd, 0, dd + (size_t)k * n, 1, n, false,
                      sp_n1);
    if (alias) {
      zero_pad(smem + lo.dyn, n, n, ldx);
      zero_pad(smem + lo.oB, n, m, ldu);
    }
  };
  auto stage_cost = [&](int k) {
    const bool term = k == N1;
    altro::stage_rows(smem + lo.cost, ldx, Q + (size_t)k * n * n, n, n,
                      vec_n, sp_n);
    altro::stage_rows(smem + lo.oq, 0, q + (size_t)k * n, 1, n, false,
                      sp_n1);
    altro::stage_vec(smem + lo.oc, cc + k, 1, t);
    altro::stage_vec(smem + lo.orho, rho + (size_t)b * N + k, 1, t - 1);
    if (!term) {
      altro::stage_rows(smem + lo.oH, ldx, H + (size_t)k * m * n, m, n,
                        vec_n, sp_n);
      altro::stage_rows(smem + lo.oR, ldu, R + (size_t)k * m * m, m, m,
                        vec_m, sp_m);
      altro::stage_rows(smem + lo.orr, 0, r + (size_t)k * m, 1, m, false,
                        sp_m1);
    }
    if (P) {
      altro::stage_rows(smem + lo.oCx, ldx, Cx + (size_t)k * P * n, P, n,
                        vec_n, sp_n);
      if (!term)
        altro::stage_rows(smem + lo.oCu, ldu, Cu + (size_t)k * P * m, P, m,
                          vec_m, sp_m);
      altro::stage_vec(smem + lo.ob, cb + (size_t)k * P, P, t);
      altro::stage_vec(smem + lo.omask, cmask + (size_t)k * P, P,
                       nt - 1 - t);
      for (int rr = t; rr < P; rr += nt) {
        const int bi = row_blk[rr];
        altro::cp_async(smem + lo.olam + rr,
                        tab.lam[bi] + ((size_t)b * N + k) * tab.p[bi] +
                            (rr - tab.row0[bi]));
      }
    }
    if (alias) {
      zero_pad(smem + lo.cost, n, n, ldx);
      zero_pad(smem + lo.oH, m, n, ldx);
      zero_pad(smem + lo.oR, m, m, ldu);
      zero_pad(smem + lo.oCx, P, n, ldx);
      zero_pad(smem + lo.oCu, P, m, ldu);
    }
  };

  // the merit of knot kk closed: one warp per rung adds the tiles' cost
  // sums (lane-strided), each block's penalty (on the lane of its number)
  // and c, by a fixed butterfly, to the rung's J (written out at `last`)
  const int warp = t / 32, lane = t % 32, nwarps = nt / 32;
  auto close_merit = [&](bool last) {
    for (int l = warp; l < lc; l += nwarps) {
      double s = 0.0;
      for (int e = lane; e < gq + gu; e += 32)
        s += dsm[lo.dsum + l * (gq + gu) + e];
      if (lane < tab.count) {
        const int r0 = tab.row0[lane], p = tab.p[lane];
        const double* vr = dsm + lo.dv + l * P + r0;
        double vsum = 0.0;
        for (int i = 0; i < p; ++i) vsum += vr[i];
        // an SOC block: vsum = |v|^2 of its first p - 1 rows, z its last
        // row's; float flags multiplied in, as jnp does: a NaN z stays NaN
        const double z = dsm[lo.dz + l * P + r0 + p - 1];
        const double a = sqrt(vsum);
        const double a_safe = a > 0.0 ? a : 1.0;
        const double polar = a <= -z ? 1.0 : 0.0;
        const double bnd = (a > z && a > -z) ? 1.0 : 0.0;
        const double gamma = bnd * (a - z) / (2.0 * a_safe);
        const double soc =
            polar * (vsum + z * z) + ((2.0 * gamma) * gamma) * vsum;
        const double ssq = tab.cone[lane] == altro::kSoc ? soc : vsum;
        s += dsm[lo.dw + r0 + p - 1] * ssq;
      }
      if (lane == 0) s += dsm[lo.dc];
#pragma unroll
      for (int dl = 16; dl > 0; dl >>= 1) s += __shfl_xor_sync(kFull, s, dl);
      if (lane == 0) {
        const double J = dsm[lo.dJ + l] + s;
        dsm[lo.dJ + l] = J;
        if (last) Jout[(size_t)b * L + l0 + l] = (T)J;
      }
    }
  };

  stage_k(0);
  altro::cp_async_commit();
  const int LT = (lc + 1) / 2;
  const int gall = gq + gu + lo.gc;
  // two threads per tile: each takes every other 4-step of the inner
  // dimension, they add their sums by a shuffle, and each stores every
  // other row of the tile
  const int part = t & 1, pair = t >> 1, pairs = nt >> 1;
  const T* Kk = smem;
  const T* dk = smem + lo.od;
  const T* ubk = smem + lo.oub;
  const T* xbk = smem + lo.oxb;
  const T* Ak = smem + lo.dyn;
  const T* Bk = smem + lo.oB;
  const T* ddk = smem + lo.odd;
  const T* sQ = smem + lo.cost;
  const T* sq = smem + lo.oq;
  const T* sH = smem + lo.oH;
  const T* sR = smem + lo.oR;
  const T* sr = smem + lo.orr;
  const T* sCx = smem + lo.oCx;
  const T* sCu = smem + lo.oCu;
  T* Uc = smem + lo.U;
  for (int k = 0; k <= N1; ++k) {
    const bool term = k == N1;
    // knot k's scenario rows have landed, and every thread is past knot
    // k-1 (the closing of its merit excepted), whose rows the copies of
    // knot k now take
    altro::cp_async_wait_all();
    __syncthreads();
    if (!term) stage_dyn(k);
    if (!alias || term) stage_cost(k);
    altro::cp_async_commit();
    const T* Xc = smem + lo.X + (k & 1) * lo.xst;
    T* Xn = smem + lo.X + ((k + 1) & 1) * lo.xst;

    // U_k: rows i0..i0+3, rungs 2 lt and 2 lt + 1 (the row tiles fastest,
    // so that neighbouring threads store neighbouring entries); u = 0 at
    // the terminal knot
    for (int base = 0; !term && base < gu * LT; base += pairs) {
      const int qq = min(base + pair, gu * LT - 1);
      const bool on = base + pair < gu * LT;
      const int i0 = (qq % gu) * 4, lt = qq / gu;
      const int la = min(2 * lt, lc - 1), lb = min(2 * lt + 1, lc - 1);
      T acc[4][2] = {};
      rows_by_rungs<T, true>(acc, Kk, ldx, m, i0, Xc, ldx, la, lb, n, xbk,
                             part);
      pair_sum(acc);
      if (!on) continue;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + rr;
        if ((rr & 1) != part || i >= m) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int l = 2 * lt + c;
          if (l >= lc) break;
          const T u = (ubk[i] + al[l] * dk[i]) + acc[rr][c];
          Uc[l * ldu + i] = u;
          Us[(((size_t)b * L + l0 + l) * N1 + k) * m + i] = u;
        }
      }
    }
    if (k > 0) close_merit(false);
    // U_k complete, and the knot's rows landed
    altro::cp_async_wait_all();
    __syncthreads();
    if (k + 1 < N1) {
      stage_k(k + 1);
      altro::cp_async_commit();
    }
    // X_{k+1} = (A X + B U) + dd, split as U_k
    for (int base = 0; !term && base < gq * LT; base += pairs) {
      const int qq = min(base + pair, gq * LT - 1);
      const bool on = base + pair < gq * LT;
      const int i0 = (qq % gq) * 4, lt = qq / gq;
      const int la = min(2 * lt, lc - 1), lb = min(2 * lt + 1, lc - 1);
      T acc[4][2] = {};
      rows_by_rungs<T, false>(acc, Ak, ldx, n, i0, Xc, ldx, la, lb, n, xbk,
                              part);
      rows_by_rungs<T, false>(acc, Bk, ldu, n, i0, Uc, ldu, la, lb, m, xbk,
                              part);
      pair_sum(acc);
      if (!on) continue;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + rr;
        if ((rr & 1) != part || i >= n) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int l = 2 * lt + c;
          if (l >= lc) break;
          const T x = acc[rr][c] + ddk[i];
          Xn[l * ldx + i] = x;
          Xs[(((size_t)b * L + l0 + l) * N + k + 1) * n + i] = x;
        }
      }
    }
    if (alias && !term) {
      // the dynamics rows are read no more: the cost and constraint rows
      // take their place
      __syncthreads();
      stage_cost(k);
      altro::cp_async_commit();
      altro::cp_async_wait_all();
      __syncthreads();
    }
    // the merit's products of knot k (sums in double): tiles of the Q
    // rows, the control rows, the constraint rows
    for (int base = 0; base < gall * LT; base += pairs) {
      const int qq = min(base + pair, gall * LT - 1);
      const bool on = base + pair < gall * LT;
      const int g = qq % gall, lt = qq / gall;
      const int la = min(2 * lt, lc - 1), lb = min(2 * lt + 1, lc - 1);
      const int kind = g < gq ? 0 : g < gq + gu ? 1 : 2;
      const int i0 = 4 * (kind == 0 ? g : kind == 1 ? g - gq : g - gq - gu);
      const int rows = kind == 0 ? n : kind == 1 ? m : P;
      double sx[4][2] = {}, su[4][2] = {};
      rows_by_rungs<double, false>(sx, kind == 0 ? sQ : kind == 1 ? sH : sCx,
                                   ldx, rows, i0, Xc, ldx, la, lb, n, xbk,
                                   part);
      if (kind != 0 && !term)
        rows_by_rungs<double, false>(su, kind == 1 ? sR : sCu, ldu, rows, i0,
                                     Uc, ldu, la, lb, m, xbk, part);
      pair_sum(sx);
      pair_sum(su);
      if (!on) continue;
      if (kind < 2) {
        if (part) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int l = 2 * lt + c;
          if (l >= lc) break;
          double s = 0.0;
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int i = i0 + rr;
            if (i >= rows) break;
            if (kind == 0)
              s += (double)Xc[l * ldx + i] *
                   ((double)sq[i] + 0.5 * sx[rr][c]);
            else if (!term)
              s += (double)Uc[l * ldu + i] *
                   (((double)sr[i] + 0.5 * su[rr][c]) + sx[rr][c]);
          }
          dsm[lo.dsum + l * (gq + gu) + g] = s;
        }
        continue;
      }
      const double rk = (double)smem[lo.orho];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int rw = i0 + rr;
        if ((rr & 1) != part || rw >= P) continue;
        const int bi = row_blk[rw];
        const bool soc_last = tab.cone[bi] == altro::kSoc &&
                              rw - tab.row0[bi] == tab.p[bi] - 1;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int l = 2 * lt + c;
          if (l >= lc) break;
          const double z = (double)smem[lo.olam + rw] +
                           rk * ((sx[rr][c] + su[rr][c]) +
                                 (double)smem[lo.ob + rw]);
          double sq2 = z * z;
          // max(z, 0), NaN propagating like jnp.maximum
          if (tab.cone[bi] == altro::kNonpos && !(z > 0.0) && z == z)
            sq2 = 0.0;
          if (soc_last) sq2 = 0.0;
          dsm[lo.dz + l * P + rw] = z;
          dsm[lo.dv + l * P + rw] = sq2;
        }
        if (lt == 0)
          dsm[lo.dw + rw] = (double)smem[lo.omask + rw] * (0.5 / rk);
      }
    }
    if (t == 0) dsm[lo.dc] = (double)smem[lo.oc];
  }
  __syncthreads();
  close_merit(true);
}

template <typename T>
__global__ void __launch_bounds__(kRungThreads) ls_rollout_al_wide_rung(
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
  __shared__ double red[kRungThreads / 32];
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
      for (int w = 0; w < kRungThreads / 32; ++w) knot += red[w];
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
int launch_wide(const Args<T>& a, const altro::BlockTable<T>& table,
                const Ladder<T>& ladder, cudaStream_t stream) {
  // rung chunks: as many as it takes to give every SM of this device a
  // block, at most L
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int chunks = std::min(a.L, std::max(1, (sms + a.Bt - 1) / a.Bt));
  const int Lc = (a.L + chunks - 1) / chunks;
  chunks = (a.L + Lc - 1) / Lc;
  if (Lc < kLadderRungs) {
    ls_rollout_al_wide_rung<T>
        <<<dim3((unsigned)a.Bt, (unsigned)a.L), kRungThreads, 0, stream>>>(
            a.Q, a.q, a.R, a.r, a.H, a.c, a.A, a.Bm, a.dd, a.Cx, a.Cu, a.cb,
            a.cmask, table, a.Xbar, a.Ubar, a.K, a.d, a.rho, ladder, a.L,
            a.Xs, a.Us, a.J, a.Bt, a.NG, a.N, a.n, a.m, a.P);
    return (int)cudaGetLastError();
  }
  auto kern = ls_rollout_al_wide<T>;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  // the dynamics rows beside the cost and constraint rows where they fit,
  // unless their sharing one place lets more blocks onto an SM (of its
  // 233,472 bytes, 1 KB per block reserved) and the grid has the blocks
  // to fill them. On an H100 80GB HBM3 at 700 W (PERF.md), B = 1024,
  // L = 11: float32 at 64 x 64 2.43 ms in one place against 3.52 side by
  // side; at n = 35-55, m = 2 side by side 0.83-1.18 ms against 0.99-1.39
  // in one place (float64 0.98-1.42 against 1.09-1.53)
  const int elem = (int)sizeof(T);
  const size_t own = AlLayout(a.n, a.m, a.P, Lc, elem, 0).bytes(elem);
  const size_t shared = AlLayout(a.n, a.m, a.P, Lc, elem, 1).bytes(elem);
  auto per_sm = [&](size_t b) {
    return std::min(kRollBlocks,
                    (int)(233472 / (b + attr.sharedSizeBytes + 1024)));
  };
  const int alias =
      own > 232448 - attr.sharedSizeBytes ||
      ((long)a.Bt * chunks > (long)sms * per_sm(own) &&
       per_sm(shared) > per_sm(own));
  const size_t bytes = alias ? shared : own;
  e = altro::wide::prepare(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  // as many threads as the tiles need (at least 128, at most kRollThreads)
  const AlLayout lo(a.n, a.m, a.P, Lc, elem, alias);
  const int tiles = (lo.gq + lo.gu + lo.gc) * ((Lc + 1) / 2) * 2;
  const int threads =
      std::min(kRollThreads, std::max(128, (tiles + 31) / 32 * 32));
  const int v = 16 / elem;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_n = a.n % v == 0 && aligned(a.A) && aligned(a.K) &&
                    aligned(a.Q) && aligned(a.H) && aligned(a.Cx);
  const int vec_m = a.m % v == 0 && aligned(a.Bm) && aligned(a.R) &&
                    aligned(a.Cu);
  kern<<<dim3((unsigned)a.Bt, (unsigned)chunks), threads, bytes, stream>>>(
      a.Q, a.q, a.R, a.r, a.H, a.c, a.A, a.Bm, a.dd, a.Cx, a.Cu, a.cb,
      a.cmask, table, a.Xbar, a.Ubar, a.K, a.d, a.rho, ladder, a.L, Lc,
      vec_n, vec_m, alias, a.Xs, a.Us, a.J, a.Bt, a.NG, a.N, a.n, a.m, a.P);
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
    return launch_wide<T>(a, table, ladder, s);
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
