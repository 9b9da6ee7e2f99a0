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
// LTI/LTV problem data) or per lane [Bt, N-1, ...]. The solver's open-loop
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
  const int b0 = blockIdx.x * S;
  const int b = b0 + s;
  const bool active = in_block && b < Bt;
  const int nscen = min(S, Bt - b0);

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
int launch_group(const T* A, const T* Bm, const T* dd, int per_lane,
                 const T* Xbar, const T* Ubar, const T* K, const T* d,
                 const Ladder<T>& ladder, int L, T* Xs, T* Us, int Bt, int N,
                 int n, int m, cudaStream_t stream) {
  // S scenarios per block: up to 128 threads, fewer while that leaves
  // under two blocks per SM (264 on the H100's 132)
  const int per = L * G;
  const int S = std::max(1, std::min(128 / per, (Bt + 263) / 264));
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
  const unsigned blocks = (unsigned)((Bt + S - 1) / S);
  ls_rollout_kernel<T, G><<<blocks, threads, bytes, stream>>>(
      A, Bm, dd, per_lane, Xbar, Ubar, K, d, ladder, L, S, Xs, Us, Bt, N, n,
      m);
  return (int)cudaGetLastError();
}

// The wide body, for n or m above kNarrowDim (up to kMaxDim): a block of
// kWideThreads = kMaxDim threads per (scenario, rung) on grid (Bt, L),
// thread i owning row i of u and of x+, with x, dx and u exchanged through
// shared memory and the block barrier; the rows are read from device
// memory, thread i striding along row i of K, A and B. Bound at n = m = 64,
// B = 1024, L = 11: the bytes (0.14 ms, Xs and Us written); it reaches
// ~11 ms: every block reads the knot's A and B rows anew, uncoalesced,
// behind three barriers per knot (PERF.md).
constexpr int kWideThreads = altro::kMaxDim;

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
ls_rollout_wide(const T* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ dd, int per_lane,
                const T* __restrict__ Xbar, const T* __restrict__ Ubar,
                const T* __restrict__ K, const T* __restrict__ d,
                Ladder<T> ladder, int L, T* __restrict__ Xs,
                T* __restrict__ Us, int Bt, int N, int n, int m) {
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
      const size_t kd = per_lane ? (size_t)b * N1 + k : (size_t)k;
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
int launch_wide(const T* A, const T* Bm, const T* dd, int per_lane,
                const T* Xbar, const T* Ubar, const T* K, const T* d,
                const Ladder<T>& ladder, int L, T* Xs, T* Us, int Bt, int N,
                int n, int m, cudaStream_t stream) {
  ls_rollout_wide<T><<<dim3((unsigned)Bt, (unsigned)L), kWideThreads, 0,
                       stream>>>(A, Bm, dd, per_lane, Xbar, Ubar, K, d,
                                 ladder, L, Xs, Us, Bt, N, n, m);
  return (int)cudaGetLastError();
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
  const T* a = (const T*)A;
  const T* bm = (const T*)Bm;
  const T* dv = (const T*)dd;
  const T* xb = (const T*)Xbar;
  const T* ub = (const T*)Ubar;
  const T* k = (const T*)K;
  const T* df = (const T*)d;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > altro::kNarrowDim || m > altro::kNarrowDim)
    return launch_wide<T>(a, bm, dv, per_lane, xb, ub, k, df, ladder, L,
                          (T*)Xs, (T*)Us, Bt, N, n, m, s);
  if (n <= 16 && m <= 16)
    return launch_group<T, 16>(a, bm, dv, per_lane, xb, ub, k, df, ladder, L,
                               (T*)Xs, (T*)Us, Bt, N, n, m, s);
  return launch_group<T, 32>(a, bm, dv, per_lane, xb, ub, k, df, ladder, L,
                             (T*)Xs, (T*)Us, Bt, N, n, m, s);
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
