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
// LTI/LTV problem data, read by every thread) or per lane [Bt, N-1, ...].
//
// Thread mapping: one thread per (scenario, rung), consecutive threads on
// the rungs of one scenario so they share its K/xbar/ubar/d reads in L1.
// The knot loop runs inside the thread; x, dx and u live in registers
// (fully unrolled loops over the compile-time widths NM/MM, guarded by the
// runtime n/m). Widths 16/8 serve the flagship and the rocket, 16/16 the
// quadruped (n = m = 12; at 32/32 its f64 build spills), 32/32 the rest.
//
// What bounds it on the H100: latency of the sequential knot loop. Each
// thread does ~(n*n + 2*n*m) FMAs per knot on data it has to wait for, and
// at the flagship shape (B=1024, L=3) only 3072 threads = 24 blocks of 128
// run, on 24 of the 132 SMs. The bytes are small (~11 MB per call at
// B=1024, N=30, n=12, m=6, mostly K), so memory bandwidth is not the limit.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
struct Ladder {
  T a[altro::kMaxRungs];
};

template <typename T, int NM, int MM>
__global__ void __launch_bounds__(128)
ls_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ dd, int per_lane,
                  const T* __restrict__ Xbar, const T* __restrict__ Ubar,
                  const T* __restrict__ K, const T* __restrict__ d,
                  Ladder<T> ladder, int L, T* __restrict__ Xs,
                  T* __restrict__ Us, int Bt, int N, int n, int m) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)Bt * L) return;
  const int b = (int)(t / L);
  const int l = (int)(t % L);
  const int N1 = N - 1;
  const T alpha = ladder.a[l];

  const T* Ab = A + (per_lane ? (size_t)b * N1 * n * n : 0);
  const T* Bb = Bm + (per_lane ? (size_t)b * N1 * n * m : 0);
  const T* db = dd + (per_lane ? (size_t)b * N1 * n : 0);
  const T* xb = Xbar + (size_t)b * N * n;
  const T* ub = Ubar + (size_t)b * N1 * m;
  const T* Kb = K + (size_t)b * N1 * m * n;
  const T* dfb = d + (size_t)b * N1 * m;
  T* Xo = Xs + ((size_t)b * L + l) * N * n;
  T* Uo = Us + ((size_t)b * L + l) * N1 * m;

  T x[NM], dx[NM], u[MM];
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n) {
      x[i] = xb[i];
      Xo[i] = x[i];
    }
  }
  for (int k = 0; k < N1; ++k) {
    const T* xbk = xb + (size_t)k * n;
    const T* Kk = Kb + (size_t)k * m * n;
    const T* Ak = Ab + (size_t)k * n * n;
    const T* Bk = Bb + (size_t)k * n * m;
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i < n) dx[i] = x[i] - xbk[i];
    }
    // u = (ubar + alpha d) + K dx
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m) {
        T kd = T(0);
#pragma unroll
        for (int p = 0; p < NM; ++p) {
          if (p < n) kd += Kk[i * n + p] * dx[p];
        }
        u[i] = (ub[k * m + i] + alpha * dfb[k * m + i]) + kd;
        Uo[(size_t)k * m + i] = u[i];
      }
    }
    // x+ = (A x + B u) + dd
    T xn[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i < n) {
        T acc = T(0);
#pragma unroll
        for (int p = 0; p < NM; ++p) {
          if (p < n) acc += Ak[i * n + p] * x[p];
        }
#pragma unroll
        for (int p = 0; p < MM; ++p) {
          if (p < m) acc += Bk[i * m + p] * u[p];
        }
        xn[i] = acc + db[(size_t)k * n + i];
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
}

template <typename T>
int launch_ls_rollout(const void* A, const void* Bm, const void* dd,
                      int per_lane, const void* Xbar, const void* Ubar,
                      const void* K, const void* d, const double* alphas,
                      int L, void* Xs, void* Us, int Bt, int N, int n, int m,
                      void* stream) {
  if (L < 1 || L > altro::kMaxRungs || n < 1 || m < 1 ||
      n > altro::kMaxDim || m > altro::kMaxDim || N < 2 || Bt < 1)
    return (int)cudaErrorInvalidValue;
  Ladder<T> ladder;
  for (int l = 0; l < altro::kMaxRungs; ++l)
    ladder.a[l] = l < L ? (T)alphas[l] : T(0);
  const int threads = 128;
  const long long total = (long long)Bt * L;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define ALTRO_LS_ARGS                                                     \
  (const T*)A, (const T*)Bm, (const T*)dd, per_lane, (const T*)Xbar,      \
      (const T*)Ubar, (const T*)K, (const T*)d, ladder, L, (T*)Xs, (T*)Us, \
      Bt, N, n, m
  if (n <= 16 && m <= 8)
    ls_rollout_kernel<T, 16, 8><<<blocks, threads, 0, s>>>(ALTRO_LS_ARGS);
  else if (n <= 16 && m <= 16)
    ls_rollout_kernel<T, 16, 16><<<blocks, threads, 0, s>>>(ALTRO_LS_ARGS);
  else
    ls_rollout_kernel<T, 32, 32><<<blocks, threads, 0, s>>>(ALTRO_LS_ARGS);
#undef ALTRO_LS_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int altro_ls_rollout_f32(const void* A, const void* Bm,
                                    const void* dd, int per_lane,
                                    const void* Xbar, const void* Ubar,
                                    const void* K, const void* d,
                                    const double* alphas, int L, void* Xs,
                                    void* Us, int Bt, int N, int n, int m,
                                    void* stream) {
  return launch_ls_rollout<float>(A, Bm, dd, per_lane, Xbar, Ubar, K, d,
                                  alphas, L, Xs, Us, Bt, N, n, m, stream);
}

extern "C" int altro_ls_rollout_f64(const void* A, const void* Bm,
                                    const void* dd, int per_lane,
                                    const void* Xbar, const void* Ubar,
                                    const void* K, const void* d,
                                    const double* alphas, int L, void* Xs,
                                    void* Us, int Bt, int N, int n, int m,
                                    void* stream) {
  return launch_ls_rollout<double>(A, Bm, dd, per_lane, Xbar, Ubar, K, d,
                                   alphas, L, Xs, Us, Bt, N, n, m, stream);
}
