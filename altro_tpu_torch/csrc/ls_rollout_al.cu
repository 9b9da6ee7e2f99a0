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
// as the solver keeps it; J accumulates in the kernel's dtype. Outputs:
// Xs [Bt, L, N, n] (knot 0 = xbar_0), Us [Bt, L, N-1, m], J [Bt, L].
//
// Thread mapping: one thread per (scenario, rung), consecutive threads on
// the rungs of one scenario (they share its xbar/ubar/K/d/lambda reads in
// L1), x, dx and u in registers (compile-time widths NM/MM, guarded by the
// runtime n/m). Every thread of a block walks the same knot, so the knot's
// shared rows (Q, q, R, r, H, c, A, B, dd and the packed constraint rows)
// are staged into shared memory once per knot and block with
// __syncthreads; lambda and rho are read per lane from global memory.
//
// What bounds it on the H100: latency of the sequential knot loop. Per knot
// a thread reads ~(n^2 + m^2 + 2nm + P(n+m)) shared values and does
// O(n^2 + nm + P(n + m)) FLOPs per rung; at the rocket shape (B=1024, L=6,
// N=21, n=6, m=3, 15 rows) that is ~300 FLOPs per scenario-rung-knot and
// 6,144 threads = 48 blocks of 128 on 48 of the 132 SMs, so neither bytes
// nor FLOPs come near the card's limits.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
struct Ladder {
  T a[altro::kMaxRungs];
};

// Shared-memory size of one knot's staged rows, in elements:
//   Q[n*n] q[n] R[m*m] r[m] H[m*n] c[1] A[n*n] B[n*m] dd[n]
//   Cx[P*n] Cu[P*m] b[P] mask[P]
__host__ __device__ inline int al_knot_elems(int n, int m, int P) {
  return 2 * n * n + 2 * n + m * m + m + 2 * m * n + 1 + P * (n + m + 2);
}

template <typename T>
__device__ inline void stage(T* dst, const T* __restrict__ src, int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// 1/2 x'Qx + q'x + c (+ 1/2 u'Ru + r'u + u'Hx), in the TPU kernel's order
template <typename T, int NM, int MM>
__device__ inline T stage_cost(const T* sQ, const T* sq, const T* sR,
                               const T* sr, const T* sH, T c, const T* x,
                               const T* u, bool with_u, int n, int m) {
  T jj = c;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n) {
      T qx = sq[i];
#pragma unroll
      for (int j = 0; j < NM; ++j)
        if (j < n) qx += (T(0.5) * sQ[i * n + j]) * x[j];
      jj += x[i] * qx;
    }
  }
  if (with_u) {
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m) {
        T ru = sr[i];
#pragma unroll
        for (int j = 0; j < MM; ++j)
          if (j < m) ru += (T(0.5) * sR[i * m + j]) * u[j];
#pragma unroll
        for (int j = 0; j < NM; ++j)
          if (j < n) ru += sH[i * n + j] * x[j];
        jj += u[i] * ru;
      }
    }
  }
  return jj;
}

// sum over blocks of mask |proj_polar(lam + rho c)|^2 / (2 rho)
template <typename T, int NM, int MM>
__device__ inline T penalty(const altro::BlockTable<T>& tab, const T* sCx,
                            const T* sCu, const T* sb, const T* smask,
                            const T* x, const T* u, bool with_u,
                            size_t lane_knot, T rho, int n, int m) {
  const T inv2rho = T(0.5) / rho;
  T pen = T(0);
  for (int bi = 0; bi < tab.count; ++bi) {
    const int r0 = tab.row0[bi], p = tab.p[bi], cone = tab.cone[bi];
    const T* lamk = tab.lam[bi] + lane_knot * p;
    T ssq = T(0), a2 = T(0), sv = T(0);
    for (int r = 0; r < p; ++r) {
      const int rr = r0 + r;
      T c = sb[rr];
#pragma unroll
      for (int i = 0; i < NM; ++i)
        if (i < n) c += sCx[rr * n + i] * x[i];
      if (with_u) {
#pragma unroll
        for (int j = 0; j < MM; ++j)
          if (j < m) c += sCu[rr * m + j] * u[j];
      }
      T z = lamk[r] + rho * c;
      if (cone == altro::kSoc) {
        if (r < p - 1)
          a2 += z * z;
        else
          sv = z;
      } else {
        // max(z, 0), NaN propagating like jnp.maximum
        if (cone == altro::kNonpos && !(z > T(0)) && z == z) z = T(0);
        ssq += z * z;
      }
    }
    if (cone == altro::kSoc) {
      const T a = sqrt(a2);
      const T a_safe = a > T(0) ? a : T(1);
      // float flags multiplied in, as jnp does: a NaN z stays NaN
      const T polar = a <= -sv ? T(1) : T(0);
      const T bnd = (a > sv && a > -sv) ? T(1) : T(0);
      const T gamma = bnd * (a - sv) / (T(2) * a_safe);
      ssq = polar * (a2 + sv * sv) + ((T(2) * gamma) * gamma) * a2;
    }
    pen += (smask[r0] * inv2rho) * ssq;
  }
  return pen;
}

template <typename T, int NM, int MM>
__global__ void __launch_bounds__(128) ls_rollout_al_kernel(
    const T* __restrict__ Q, const T* __restrict__ q,
    const T* __restrict__ R, const T* __restrict__ r,
    const T* __restrict__ H, const T* __restrict__ cc,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ dd, const T* __restrict__ Cx,
    const T* __restrict__ Cu, const T* __restrict__ cb,
    const T* __restrict__ cmask, altro::BlockTable<T> table,
    const T* __restrict__ Xbar, const T* __restrict__ Ubar,
    const T* __restrict__ K, const T* __restrict__ d,
    const T* __restrict__ rho, Ladder<T> ladder, int L, T* __restrict__ Xs,
    T* __restrict__ Us, T* __restrict__ Jout, int Bt, int N, int n, int m,
    int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ altro::BlockTable<T> tab;
  T* smem = reinterpret_cast<T*>(smem_raw);
  if (threadIdx.x == 0) tab = table;
  T* sQ = smem;
  T* sq = sQ + n * n;
  T* sR = sq + n;
  T* sr = sR + m * m;
  T* sH = sr + m;
  T* sc = sH + m * n;
  T* sA = sc + 1;
  T* sB = sA + n * n;
  T* sdd = sB + n * m;
  T* sCx = sdd + n;
  T* sCu = sCx + P * n;
  T* sb = sCu + P * m;
  T* smask = sb + P;

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < (long long)Bt * L;
  const int b = active ? (int)(t / L) : 0;
  const int l = active ? (int)(t % L) : 0;
  const int N1 = N - 1;
  const T alpha = ladder.a[l];

  const T* xb = Xbar + (size_t)b * N * n;
  const T* ub = Ubar + (size_t)b * N1 * m;
  const T* Kb = K + (size_t)b * N1 * m * n;
  const T* dfb = d + (size_t)b * N1 * m;
  T* Xo = Xs + ((size_t)b * L + l) * N * n;
  T* Uo = Us + ((size_t)b * L + l) * N1 * m;

  T x[NM], dx[NM], u[MM];
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    x[i] = T(0);
    if (active && i < n) {
      x[i] = xb[i];
      Xo[i] = x[i];
    }
  }
#pragma unroll
  for (int i = 0; i < MM; ++i) u[i] = T(0);
  T J = T(0);

  for (int k = 0; k < N1; ++k) {
    __syncthreads();  // every thread is done with the previous knot's rows
    stage(sQ, Q + (size_t)k * n * n, n * n);
    stage(sq, q + (size_t)k * n, n);
    stage(sR, R + (size_t)k * m * m, m * m);
    stage(sr, r + (size_t)k * m, m);
    stage(sH, H + (size_t)k * m * n, m * n);
    stage(sc, cc + k, 1);
    stage(sA, A + (size_t)k * n * n, n * n);
    stage(sB, Bm + (size_t)k * n * m, n * m);
    stage(sdd, dd + (size_t)k * n, n);
    stage(sCx, Cx + (size_t)k * P * n, P * n);
    stage(sCu, Cu + (size_t)k * P * m, P * m);
    stage(sb, cb + (size_t)k * P, P);
    stage(smask, cmask + (size_t)k * P, P);
    __syncthreads();
    if (!active) continue;

    const T* xbk = xb + (size_t)k * n;
    const T* Kk = Kb + (size_t)k * m * n;
#pragma unroll
    for (int i = 0; i < NM; ++i)
      if (i < n) dx[i] = x[i] - xbk[i];
    // u = (ubar + alpha d) + K dx
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m) {
        T kd = T(0);
#pragma unroll
        for (int p = 0; p < NM; ++p)
          if (p < n) kd += Kk[i * n + p] * dx[p];
        u[i] = (ub[k * m + i] + alpha * dfb[k * m + i]) + kd;
        Uo[(size_t)k * m + i] = u[i];
      }
    }
    const T jj = stage_cost<T, NM, MM>(sQ, sq, sR, sr, sH, sc[0], x, u, true,
                                       n, m);
    const T pen = penalty<T, NM, MM>(tab, sCx, sCu, sb, smask, x, u, true,
                                     (size_t)b * N + k, rho[(size_t)b * N + k],
                                     n, m);
    J = (J + jj) + pen;
    // x+ = (A x + B u) + dd
    T xn[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i < n) {
        T acc = T(0);
#pragma unroll
        for (int p = 0; p < NM; ++p)
          if (p < n) acc += sA[i * n + p] * x[p];
#pragma unroll
        for (int p = 0; p < MM; ++p)
          if (p < m) acc += sB[i * m + p] * u[p];
        xn[i] = acc + sdd[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i < n) {
        x[i] = xn[i];
        Xo[(size_t)(k + 1) * n + i] = x[i];
      }
    }
  }

  // terminal knot: state cost and penalty with u = 0
  __syncthreads();
  stage(sQ, Q + (size_t)N1 * n * n, n * n);
  stage(sq, q + (size_t)N1 * n, n);
  stage(sc, cc + N1, 1);
  stage(sCx, Cx + (size_t)N1 * P * n, P * n);
  stage(sb, cb + (size_t)N1 * P, P);
  stage(smask, cmask + (size_t)N1 * P, P);
  __syncthreads();
  if (!active) return;
  const T jj = stage_cost<T, NM, MM>(sQ, sq, sR, sr, sH, sc[0], x, u, false,
                                     n, m);
  const T pen = penalty<T, NM, MM>(tab, sCx, sCu, sb, smask, x, u, false,
                                   (size_t)b * N + N1, rho[(size_t)b * N + N1],
                                   n, m);
  Jout[(size_t)b * L + l] = (J + jj) + pen;
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
                         void* Xs, void* Us, void* J, int Bt, int N, int n,
                         int m, int P, void* stream) {
  if (L < 1 || L > altro::kMaxRungs || n < 1 || m < 1 ||
      n > altro::kMaxDim || m > altro::kMaxDim || P < 0 ||
      P > altro::kMaxRows || N < 2 || Bt < 1)
    return (int)cudaErrorInvalidValue;
  altro::BlockTable<T> table;
  if (!altro::make_table(nblocks, meta, lams, P, &table))
    return (int)cudaErrorInvalidValue;
  Ladder<T> ladder;
  for (int i = 0; i < altro::kMaxRungs; ++i)
    ladder.a[i] = i < L ? (T)alphas[i] : T(0);
  const size_t bytes = (size_t)al_knot_elems(n, m, P) * sizeof(T);
  const int threads = 128;
  const long long total = (long long)Bt * L;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define ALTRO_LSAL_LAUNCH(NM, MM)                                            \
  do {                                                                       \
    auto kern = ls_rollout_al_kernel<T, NM, MM>;                             \
    if (bytes > 48 * 1024 - sizeof(table)) {                                 \
      cudaError_t e = cudaFuncSetAttribute(                                  \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);    \
      if (e != cudaSuccess) return (int)e;                                   \
    }                                                                        \
    kern<<<blocks, threads, bytes, s>>>(                                     \
        (const T*)Q, (const T*)q, (const T*)R, (const T*)r, (const T*)H,     \
        (const T*)c, (const T*)A, (const T*)Bm, (const T*)dd, (const T*)Cx,  \
        (const T*)Cu, (const T*)cb, (const T*)cmask, table,                  \
        (const T*)Xbar, (const T*)Ubar, (const T*)K, (const T*)d,            \
        (const T*)rho, ladder, L, (T*)Xs, (T*)Us, (T*)J, Bt, N, n, m, P);    \
  } while (0)
  if (n <= 16 && m <= 8)
    ALTRO_LSAL_LAUNCH(16, 8);
  else
    ALTRO_LSAL_LAUNCH(32, 32);
#undef ALTRO_LSAL_LAUNCH
  return (int)cudaGetLastError();
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
      int L, void* Xs, void* Us, void* J, int Bt, int N, int n, int m,       \
      int P, void* stream) {                                                 \
    return launch_ls_rollout_al<T>(Q, q, R, r, H, c, A, Bm, dd, Cx, Cu, cb,  \
                                   cmask, nblocks, meta, lams, Xbar, Ubar,   \
                                   K, d, rho, alphas, L, Xs, Us, J, Bt, N,   \
                                   n, m, P, stream);                         \
  }

ALTRO_LSAL_ENTRY(altro_ls_rollout_al_f32, float)
ALTRO_LSAL_ENTRY(altro_ls_rollout_al_f64, double)
