// Closed-loop line-search ladder rollout.
//
// Replaces the TPU kernel altro_tpu/ops/rollout.py: batched_ls_rollout
// (Pallas body `_kernel`). For every scenario b and rung l of the static
// step-size ladder alpha:
//
//   u_k   = ubar_k + alpha_l d_k + K_k (x_k - xbar_k)
//   x_k+1 = A_k x_k + B_k u_k + dd_k,          x_0 = xbar_0
//
// Xs [Bt, L, N, n] and Us [Bt, L, N-1, m] are written whole (knot 0 of Xs
// included). A/B/dd are either shared [N-1, ...] (per_lane = 0: the solver's
// LTI/LTV problem data), shared per group of scenarios ([G, N-1, ...],
// per_lane = 0, Bt / G contiguous scenarios to a group: the quadruped's
// contact schedules; a block's scenarios lie in one group, grid.y runs over
// the groups) or per lane [Bt, N-1, ...]. The solver's open-loop
// init rollout is the L = 1 form with K = d = 0 and alpha = 1.
//
// Thread mapping: a group of G = 16 lanes (n, m <= 16) or 32 lanes (up to
// 32) carries one (scenario, rung); lane i owns row i of u and of x+:
// u_i = ubar_i + alpha d_i + K_i . dx and x+_i = A_i . x + B_i . u + dd_i,
// with x, dx and u exchanged inside the group by __shfl_sync. A block holds
// S scenarios with all their L rungs. Each knot, a scenario's K_k, d_k,
// xbar_k and ubar_k (and its A_k, B_k, dd_k when per lane) are staged once
// into shared memory for its L rungs, and the shared A_k, B_k, dd_k once per
// block, by cp.async one knot ahead into a double buffer, so the loads of
// knot k+1 overlap the arithmetic of knot k; one __syncthreads per knot.
// Consecutive lanes store consecutive entries of X and U.
//
// What bounds it on the H100: at B=1024, N=30, n=12, m=6, L=3 it moves
// ~18 MB (K 9 MB read, Xs 4.4 MB and Us 2.1 MB written): 5.4 us at
// 3.35 TB/s, against ~0.05 GFLOP (0.8 us at 67 TFLOP/s f32), so the bytes
// bound it. What it reaches is set by the knot chain's latency (per knot one
// barrier and 2n + m dependent shuffle-FMA steps), hidden by the ~12 warps
// per SM that the 1,536 groups of 16 lanes give.
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

// Staged elements per scenario and knot: K[m*n] d[m] xbar[n] ubar[m], then
// A[n*n] B[n*m] dd[n] when the dynamics are per lane.
__host__ __device__ inline int scen_elems(int n, int m, int per_lane) {
  return m * n + 2 * m + n + (per_lane ? n * n + n * m + n : 0);
}

// Shared dynamics A[n*n] B[n*m] dd[n] at the front of each buffer.
__host__ __device__ inline int shared_elems(int n, int m, int per_lane) {
  return per_lane ? 0 : n * n + n * m + n;
}

template <typename T, int G>
__global__ void __launch_bounds__(1024)
ls_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ dd, int per_lane,
                  const T* __restrict__ Xbar, const T* __restrict__ Ubar,
                  const T* __restrict__ K, const T* __restrict__ d,
                  Ladder<T> ladder, int L, int S, T* __restrict__ Xs,
                  T* __restrict__ Us, int Bt, int N, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int N1 = N - 1;
  const int tid = threadIdx.x;
  const int lane = tid % G;
  const int grp = tid / G;
  const int l = grp % L;
  const bool in_block = grp / L < S;  // the last warp may hold padding
  const int s = in_block ? grp / L : 0;
  // grid.y: the group of scenarios whose shared dynamics the block reads
  // (one group of Bt when shared or per lane); no block straddles two
  const int reps = Bt / (int)gridDim.y;
  const int bg = blockIdx.x * S;  // the block's first scenario in the group
  const int b0 = (int)blockIdx.y * reps + bg;
  const int b = b0 + s;
  const bool active = in_block && bg + s < reps;
  const int nscen = min(S, reps - bg);
  A += (size_t)blockIdx.y * N1 * n * n;
  Bm += (size_t)blockIdx.y * N1 * n * m;
  dd += (size_t)blockIdx.y * N1 * n;

  const int mn = m * n;
  const int sw = shared_elems(n, m, per_lane);
  const int scen = scen_elems(n, m, per_lane);
  const int buf = sw + S * scen;
  const int o_d = mn, o_xb = mn + m, o_ub = mn + m + n, o_A = mn + 2 * m + n;
  const int o_B = o_A + n * n, o_dd = o_B + n * m;

  // knot k's rows into dst: coalesced, one element per thread and step
  auto stage = [&](int k, T* dst) {
    if (!per_lane) {
      for (int e = tid; e < n * n; e += blockDim.x)
        altro::cp_async(dst + e, A + (size_t)k * n * n + e);
      for (int e = tid; e < n * m; e += blockDim.x)
        altro::cp_async(dst + n * n + e, Bm + (size_t)k * n * m + e);
      for (int e = tid; e < n; e += blockDim.x)
        altro::cp_async(dst + n * n + n * m + e, dd + (size_t)k * n + e);
    }
    for (int e = tid; e < nscen * scen; e += blockDim.x) {
      const int si = e / scen, j = e % scen;
      const size_t bb = (size_t)(b0 + si);
      const T* src;
      if (j < o_d)
        src = K + (bb * N1 + k) * mn + j;
      else if (j < o_xb)
        src = d + (bb * N1 + k) * m + (j - o_d);
      else if (j < o_ub)
        src = Xbar + (bb * N + k) * n + (j - o_xb);
      else if (j < o_A)
        src = Ubar + (bb * N1 + k) * m + (j - o_ub);
      else if (j < o_B)
        src = A + (bb * N1 + k) * n * n + (j - o_A);
      else if (j < o_dd)
        src = Bm + (bb * N1 + k) * n * m + (j - o_B);
      else
        src = dd + (bb * N1 + k) * n + (j - o_dd);
      altro::cp_async(dst + sw + e, src);
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

  stage(0, smem);
  altro::cp_async_commit();
  for (int k = 0; k < N1; ++k) {
    // knot k has landed, and every thread is past knot k-1, whose buffer
    // the prefetch of knot k+1 now takes
    altro::cp_async_wait_all();
    __syncthreads();
    if (k + 1 < N1) {
      stage(k + 1, smem + ((k + 1) & 1) * buf);
      altro::cp_async_commit();
    }
    const T* cur = smem + (k & 1) * buf;
    const T* sc = cur + sw + s * scen;
    const T* sA = per_lane ? sc + o_A : cur;
    const T* sB = per_lane ? sc + o_B : cur + n * n;
    const T* sdd = per_lane ? sc + o_dd : cur + n * n + n * m;

    // u = (ubar + alpha d) + K dx
    const T dx = x - sc[o_xb + xi];
    T kd = T(0);
#pragma unroll
    for (int p = 0; p < G; ++p) {
      if (p < n) kd += sc[ui * n + p] * __shfl_sync(kFull, dx, p, G);
    }
    const T u = (sc[o_ub + ui] + alpha * sc[o_d + ui]) + kd;
    // x+ = (A x + B u) + dd
    T acc = T(0);
#pragma unroll
    for (int p = 0; p < G; ++p) {
      if (p < n) acc += sA[xi * n + p] * __shfl_sync(kFull, x, p, G);
    }
#pragma unroll
    for (int p = 0; p < G; ++p) {
      if (p < m) acc += sB[xi * m + p] * __shfl_sync(kFull, u, p, G);
    }
    x = acc + sdd[xi];
    if (active) {
      if (lane < m) Uo[(size_t)k * m + lane] = u;
      if (lane < n) Xo[(size_t)(k + 1) * n + lane] = x;
    }
  }
}

template <typename T, int G>
int launch_group(const T* A, const T* Bm, const T* dd, int per_lane, int NG,
                 const T* Xbar, const T* Ubar, const T* K, const T* d,
                 const Ladder<T>& ladder, int L, T* Xs, T* Us, int Bt, int N,
                 int n, int m, cudaStream_t stream) {
  // S scenarios per block: up to 128 threads, fewer while that leaves
  // under two blocks per SM (264 on the H100's 132), at most a group's
  const int per = L * G;
  const int reps = Bt / NG;
  const int S = std::max(1, std::min({128 / per, (Bt + 263) / 264, reps}));
  const int threads = (S * per + 31) / 32 * 32;
  const size_t bytes = 2 * (size_t)(shared_elems(n, m, per_lane) +
                                    S * scen_elems(n, m, per_lane)) *
                       sizeof(T);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // 227 KB opt-in
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ls_rollout_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((reps + S - 1) / S), (unsigned)NG);
  ls_rollout_kernel<T, G><<<grid, threads, bytes, stream>>>(
      A, Bm, dd, per_lane, Xbar, Ubar, K, d, ladder, L, S, Xs, Us, Bt, N, n,
      m);
  return (int)cudaGetLastError();
}

// The wide bodies, for n or m above kNarrowDim (up to kMaxDim); they
// replace the TPU kernel altro_tpu/ops/rollout.py: batched_ls_rollout at
// those widths. The launcher splits a scenario's ladder into chunks of Lc
// rungs along grid.y, as many as it takes to give every SM a block, and
// picks the body by Lc.
//
// The ladder body (Lc >= kLadderRungs). As the TPU kernel does
// (rollout.py:52-87), one block carries a chunk of a scenario's ladder:
// the rungs are the columns of two small products per knot,
//
//   U_k     = ubar_k 1' + d_k alpha' + K_k (X_k - xbar_k 1')  [m x n][n x Lc]
//   X_{k+1} = A_k X_k + B_k U_k + dd_k 1'          [n x (n + m)][(n + m) x Lc]
//
// each as a tiled product: 4 rows x 2 rungs per pair of threads, which take
// alternate 4-steps of the inner dimension (one 4-vector of each row and
// of each rung's state per step) and add their sums by a shuffle, so that
// the chain a knot waits for is half the dot product. A knot's rows come
// into shared memory by cp.async (16-byte copies when the widths allow),
// neighbouring threads on neighbouring addresses: the scenario's K_k, d_k,
// ubar_k, xbar_k one knot ahead (double buffer), and A_k, B_k, dd_k
// (shared, or the scenario's when per lane) during the knot's first
// product. So each scenario's K is read once whatever L, and every block
// streams the dynamics rows once per knot; the stores of U_k and X_{k+1}
// run along rows. Rows are padded to an odd count of 16-byte pieces, so
// threads reading one column of different rows hit different banks, and
// the padding holds zeros.
//
// What bounds it on the H100: at n = m = 64, B = 1024, L = 11, N = 21 the
// bytes (K 0.34 GB read once, Xs and Us 0.12 GB written; 0.14 ms at
// 3.35 TB/s in float32), against ~5.5 GFLOP (0.08 ms). What it reaches is
// set by two barriers and two short product chains per knot, overlapped
// across the blocks of an SM.
//
// The rung body (Lc < kLadderRungs: one lane, or the init form's single
// rung): a block of kRungThreads threads per (scenario, rung) on grid
// (Bt, L), thread i owning row i of u and of x+, with x, dx and u exchanged
// through shared memory and the block barrier; the rows are read from
// device memory, thread i striding along row i of K, A and B. A chunk of
// few rungs leaves the ladder body's tiles half empty and its staging
// without reuse, and at one lane the rung body's L blocks spread the
// ladder over L SMs (PERF.md: the two bodies on either side).
constexpr int kRollThreads = 256;
constexpr int kLadderRungs = 4;
constexpr int kRungThreads = altro::kMaxDim;

// Row stride for rows of w elements: a multiple of 4 elements (two for
// float64) and an odd number of 16-byte pieces.
__host__ __device__ inline int row_ld(int w, int elem) {
  const int v = 16 / elem;
  const int ld = altro::wide::pad4(w);
  return (ld / v) % 2 == 0 ? ld + v : ld;
}

// Offsets (in elements) of the ladder body's shared memory: two stages of
// the scenario rows (K [m x ldx], d, ubar, xbar), one of the dynamics rows
// (A [n x ldx], B [n x ldu], dd), two states [Lc x ldx], the controls
// [Lc x ldu] and the chunk's step sizes.
struct RollLayout {
  int ldx, ldu, kst, od, oub, oxb, ast, oB, odd, kbuf, abuf, X, xst, U,
      alpha, total;
  __host__ __device__ RollLayout(int n, int m, int Lc, int elem) {
    using altro::wide::pad4;
    ldx = row_ld(n, elem);
    ldu = row_ld(m, elem);
    od = pad4(m * ldx);
    oub = od + pad4(m);
    oxb = oub + pad4(m);
    kst = oxb + pad4(n);
    oB = pad4(n * ldx);
    odd = oB + pad4(n * ldu);
    ast = odd + pad4(n);
    kbuf = 0;
    abuf = 2 * kst;
    X = abuf + ast;
    xst = pad4(Lc * ldx);
    U = X + 2 * xst;
    alpha = U + pad4(Lc * ldu);
    total = alpha + altro::kMaxRungs;
  }
};

template <typename T>
__global__ void __launch_bounds__(kRollThreads, sizeof(T) == 8 ? 4 : 3)
ls_rollout_wide(const T* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ dd, int per_lane,
                const T* __restrict__ Xbar, const T* __restrict__ Ubar,
                const T* __restrict__ K, const T* __restrict__ d,
                Ladder<T> ladder, int L, int Lc, int vec_n, int vec_m,
                T* __restrict__ Xs, T* __restrict__ Us, int Bt, int NG, int N,
                int n, int m) {
  namespace wd = altro::wide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const RollLayout lo(n, m, Lc, (int)sizeof(T));
  const int t = threadIdx.x, nt = blockDim.x, N1 = N - 1;
  const int b = blockIdx.x, l0 = blockIdx.y * Lc, lc = min(Lc, L - l0);
  const int ldx = lo.ldx, ldu = lo.ldu;
  T* al = smem + lo.alpha;

  // zeros everywhere (the rows' padding stays zero), the chunk's step
  // sizes, and the first state, copied to Xs
  for (int e = t; e < lo.total; e += nt) smem[e] = T(0);
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

  // each thread's place in the copies of a row of width n and of width m
  const int v = 16 / (int)sizeof(T);
  const altro::Spread sp_n(vec_n ? n / v : n, t, nt);
  const altro::Spread sp_m(vec_m ? m / v : m, t, nt);
  const altro::Spread sp_n1(n, t, nt), sp_m1(m, t, nt);  // single rows
  auto stage_k = [&](int k) {
    T* dst = smem + lo.kbuf + (k & 1) * lo.kst;
    const size_t bk = (size_t)b * N1 + k;
    altro::stage_rows(dst, ldx, K + bk * m * n, m, n, vec_n, sp_n);
    altro::stage_rows(dst + lo.od, 0, d + bk * m, 1, m, false, sp_m1);
    altro::stage_rows(dst + lo.oub, 0, Ubar + bk * m, 1, m, false, sp_m1);
    altro::stage_rows(dst + lo.oxb, 0, Xbar + ((size_t)b * N + k) * n, 1, n,
                      false, sp_n1);
  };
  auto stage_ab = [&](int k) {
    T* dst = smem + lo.abuf;
    // the lane's rows, or its group's (NG groups; NG = 1: shared)
    const size_t kd = (size_t)(per_lane ? b : b / (Bt / NG)) * N1 + k;
    altro::stage_rows(dst, ldx, A + kd * n * n, n, n, vec_n, sp_n);
    altro::stage_rows(dst + lo.oB, ldu, Bm + kd * n * m, n, m, vec_m, sp_m);
    altro::stage_rows(dst + lo.odd, 0, dd + kd * n, 1, n, false, sp_n1);
  };

  stage_k(0);
  altro::cp_async_commit();
  const int RU = (m + 3) / 4, RX = (n + 3) / 4, LT = (lc + 1) / 2;
  // two threads per tile: each takes every other 4-step of the inner
  // dimension, they add their sums by a shuffle, and each stores every
  // other row of the tile
  const int part = t & 1, pair = t >> 1, pairs = nt >> 1;
  for (int k = 0; k < N1; ++k) {
    // knot k's rows have landed, and every thread is past knot k-1, whose
    // stages the next copies take: knot k's dynamics now, knot k+1's rows
    altro::cp_async_wait_all();
    __syncthreads();
    stage_ab(k);
    altro::cp_async_commit();
    if (k + 1 < N1) {
      stage_k(k + 1);
      altro::cp_async_commit();
    }
    const T* kb = smem + lo.kbuf + (k & 1) * lo.kst;
    const T* Kk = kb;
    const T* dk = kb + lo.od;
    const T* ubk = kb + lo.oub;
    const T* xbk = kb + lo.oxb;
    const T* Xc = smem + lo.X + (k & 1) * lo.xst;
    T* Xn = smem + lo.X + ((k + 1) & 1) * lo.xst;
    T* Uc = smem + lo.U;

    // U_k: rows i0..i0+3, rungs 2 lt and 2 lt + 1 (the row tiles fastest,
    // so that neighbouring threads store neighbouring entries)
    for (int base = 0; base < RU * LT; base += pairs) {
      const int qq = min(base + pair, RU * LT - 1);
      const bool on = base + pair < RU * LT;
      const int i0 = (qq % RU) * 4, lt = qq / RU;
      const int la = min(2 * lt, lc - 1), lb = min(2 * lt + 1, lc - 1);
      T acc[4][2] = {};
      for (int p = 4 * part; p < n; p += 8) {
        T xb[4], xa[4], xc[4];
        wd::ld4(xbk + p, xb);
        wd::ld4(Xc + la * ldx + p, xa);
        wd::ld4(Xc + lb * ldx + p, xc);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          xa[c] -= xb[c];
          xc[c] -= xb[c];
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          T kr[4];
          wd::ld4(Kk + min(i0 + rr, m - 1) * ldx + p, kr);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[rr][0] += kr[c] * xa[c];
            acc[rr][1] += kr[c] * xc[c];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[rr][c] += __shfl_xor_sync(wd::kFullMask, acc[rr][c], 1);
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
    // U_k complete, and knot k's dynamics landed
    if (k + 1 < N1)
      altro::cp_async_wait_group<1>();
    else
      altro::cp_async_wait_all();
    __syncthreads();
    const T* Ak = smem + lo.abuf;
    const T* Bk = Ak + lo.oB;
    const T* ddk = Ak + lo.odd;
    // X_{k+1} = (A X + B U) + dd, split as U_k
    for (int base = 0; base < RX * LT; base += pairs) {
      const int qq = min(base + pair, RX * LT - 1);
      const bool on = base + pair < RX * LT;
      const int i0 = (qq % RX) * 4, lt = qq / RX;
      const int la = min(2 * lt, lc - 1), lb = min(2 * lt + 1, lc - 1);
      T acc[4][2] = {};
      for (int p = 4 * part; p < n; p += 8) {
        T xa[4], xc[4];
        wd::ld4(Xc + la * ldx + p, xa);
        wd::ld4(Xc + lb * ldx + p, xc);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          T ar[4];
          wd::ld4(Ak + min(i0 + rr, n - 1) * ldx + p, ar);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[rr][0] += ar[c] * xa[c];
            acc[rr][1] += ar[c] * xc[c];
          }
        }
      }
      for (int p = 4 * part; p < m; p += 8) {
        T ua[4], uc[4];
        wd::ld4(Uc + la * ldu + p, ua);
        wd::ld4(Uc + lb * ldu + p, uc);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          T br[4];
          wd::ld4(Bk + min(i0 + rr, n - 1) * ldu + p, br);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[rr][0] += br[c] * ua[c];
            acc[rr][1] += br[c] * uc[c];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[rr][c] += __shfl_xor_sync(wd::kFullMask, acc[rr][c], 1);
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
  }
}

template <typename T>
__global__ void __launch_bounds__(kRungThreads)
ls_rollout_wide_rung(const T* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ dd, int per_lane,
                const T* __restrict__ Xbar, const T* __restrict__ Ubar,
                const T* __restrict__ K, const T* __restrict__ d,
                Ladder<T> ladder, int L, T* __restrict__ Xs,
                T* __restrict__ Us, int Bt, int NG, int N, int n, int m) {
  __shared__ T xs[altro::kMaxDim], dxs[altro::kMaxDim], us[altro::kMaxDim];
  const int b = blockIdx.x, l = blockIdx.y, t = threadIdx.x, N1 = N - 1;
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
  for (int k = 0; k < N1; ++k) {
    if (t < n) dxs[t] = xs[t] - xb[(size_t)k * n + t];
    __syncthreads();
    if (t < m) {
      const size_t ku = (size_t)b * N1 + k;
      const T* Kr = K + (ku * m + t) * n;
      T kd = T(0);
      for (int p = 0; p < n; ++p) kd += Kr[p] * dxs[p];
      const T u = (Ubar[ku * m + t] + alpha * d[ku * m + t]) + kd;
      us[t] = u;
      Uo[(size_t)k * m + t] = u;
    }
    __syncthreads();
    T x = T(0);
    if (t < n) {
      const size_t kd = (size_t)(per_lane ? b : b / (Bt / NG)) * N1 + k;
      const T* Ar = A + (kd * n + t) * n;
      const T* Br = Bm + (kd * n + t) * m;
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += Ar[p] * xs[p];
      for (int p = 0; p < m; ++p) acc += Br[p] * us[p];
      x = acc + dd[kd * n + t];
    }
    __syncthreads();
    if (t < n) {
      xs[t] = x;
      Xo[(size_t)(k + 1) * n + t] = x;
    }
  }
}

template <typename T>
int launch_wide(const T* A, const T* Bm, const T* dd, int per_lane, int NG,
                const T* Xbar, const T* Ubar, const T* K, const T* d,
                const Ladder<T>& ladder, int L, T* Xs, T* Us, int Bt, int N,
                int n, int m, cudaStream_t stream) {
  // rung chunks: as many as it takes to give every SM of this device a
  // block, at most L
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int chunks = std::min(L, std::max(1, (sms + Bt - 1) / Bt));
  const int Lc = (L + chunks - 1) / chunks;
  chunks = (L + Lc - 1) / Lc;
  if (Lc < kLadderRungs) {
    ls_rollout_wide_rung<T>
        <<<dim3((unsigned)Bt, (unsigned)L), kRungThreads, 0, stream>>>(
            A, Bm, dd, per_lane, Xbar, Ubar, K, d, ladder, L, Xs, Us, Bt, NG,
            N, n, m);
    return (int)cudaGetLastError();
  }
  // as many threads as the tiles need (at least 128, at most kRollThreads)
  const int elem = (int)sizeof(T);
  const size_t bytes = (size_t)RollLayout(n, m, Lc, elem).total * elem;
  const int tiles = ((n > m ? n : m) + 3) / 4 * ((Lc + 1) / 2) * 2;
  const int threads =
      std::min(kRollThreads, std::max(128, (tiles + 31) / 32 * 32));
  e = altro::wide::prepare(ls_rollout_wide<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int v = 16 / elem;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_n = n % v == 0 && aligned(A) && aligned(K);
  const int vec_m = m % v == 0 && aligned(Bm);
  ls_rollout_wide<T>
      <<<dim3((unsigned)Bt, (unsigned)chunks), threads, bytes, stream>>>(
          A, Bm, dd, per_lane, Xbar, Ubar, K, d, ladder, L, Lc, vec_n, vec_m,
          Xs, Us, Bt, NG, N, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ls_rollout(const void* A, const void* Bm, const void* dd,
                      int per_lane, int NG, const void* Xbar,
                      const void* Ubar,
                      const void* K, const void* d, const double* alphas,
                      int L, void* Xs, void* Us, int Bt, int N, int n, int m,
                      void* stream) {
  if (L < 1 || L > altro::kMaxRungs || n < 1 || m < 1 ||
      n > altro::kMaxDim || m > altro::kMaxDim || N < 2 || Bt < 1 ||
      NG < 1 || Bt % NG != 0 || NG > 65535 || (per_lane && NG != 1))
    return (int)cudaErrorInvalidValue;
  Ladder<T> ladder;
  for (int l = 0; l < altro::kMaxRungs; ++l)
    ladder.a[l] = l < L ? (T)alphas[l] : T(0);
  const T* a = (const T*)A;
  const T* bm = (const T*)Bm;
  const T* dv = (const T*)dd;
  const T* xb = (const T*)Xbar;
  const T* ub = (const T*)Ubar;
  const T* k = (const T*)K;
  const T* df = (const T*)d;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > altro::kNarrowDim || m > altro::kNarrowDim)
    return launch_wide<T>(a, bm, dv, per_lane, NG, xb, ub, k, df, ladder, L,
                          (T*)Xs, (T*)Us, Bt, N, n, m, s);
  if (n <= 16 && m <= 16)
    return launch_group<T, 16>(a, bm, dv, per_lane, NG, xb, ub, k, df, ladder,
                               L, (T*)Xs, (T*)Us, Bt, N, n, m, s);
  return launch_group<T, 32>(a, bm, dv, per_lane, NG, xb, ub, k, df, ladder,
                             L, (T*)Xs, (T*)Us, Bt, N, n, m, s);
}

}  // namespace

extern "C" int altro_ls_rollout_f32(const void* A, const void* Bm,
                                    const void* dd, int per_lane, int NG,
                                    const void* Xbar, const void* Ubar,
                                    const void* K, const void* d,
                                    const double* alphas, int L, void* Xs,
                                    void* Us, int Bt, int N, int n, int m,
                                    void* stream) {
  return launch_ls_rollout<float>(A, Bm, dd, per_lane, NG, Xbar, Ubar, K, d,
                                  alphas, L, Xs, Us, Bt, N, n, m, stream);
}

extern "C" int altro_ls_rollout_f64(const void* A, const void* Bm,
                                    const void* dd, int per_lane, int NG,
                                    const void* Xbar, const void* Ubar,
                                    const void* K, const void* d,
                                    const double* alphas, int L, void* Xs,
                                    void* Us, int Bt, int N, int n, int m,
                                    void* stream) {
  return launch_ls_rollout<double>(A, Bm, dd, per_lane, NG, Xbar, Ubar, K, d,
                                   alphas, L, Xs, Us, Bt, N, n, m, stream);
}
