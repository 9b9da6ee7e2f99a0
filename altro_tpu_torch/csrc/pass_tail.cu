// The tail of a solver pass on the fused-ladder route: everything the
// PyTorch loop body does after kernel C, in one launch.
//
// Replaces no TPU kernel: on the TPU the JAX package's pass tail is fused by
// XLA into the loop body. Here it fuses the PyTorch glue after kernel C
// (ops/pass_tail.py: pass_tail_reference, the plain version), which ran as
// well over a hundred small kernels a pass. Per scenario (lane) b, from the
// loop state s, kernel B's K, d, dV1, dV2 and kernel C's ladder Xs, Us, J:
//
//   1. the gradient metric max_k |d_k|_inf / (|u_k|_inf + 1) and pre_done;
//   2. the ladder's rung choice: the first (largest-alpha) rung whose
//      achieved / expected decrease passes ls_min_ratio (or that decreases
//      the merit where the expected decrease is ~0), finite;
//   3. the adopted trajectory (the rung, or the kept one where none passes);
//   4. per block and knot, c = Cx x + Cu u + b on it (u = 0 at the terminal
//      knot) and ctilde = proj_polar(lam + rho c) (ZERO: z; NONPOS:
//      max(z, 0); SOC: z - proj_soc(z), cones.py's formulas);
//   5. the regularization schedule;
//   6. the stop tests (dJ, stuck, exact_full, inner_done, round_end);
//   7. at a round end: the violation's inf-norm (masked by select, so an inf
//      residual at a masked knot reads 0), converged, lam <- mask ctilde
//      where the rung was accepted or the inner phase converged, rho scaled
//      and clamped where not converged;
//   8. it_rd, it, rounds, done;
//   9. the freeze: a lane whose own loop condition is false (done, the
//      outer-round cap, the iteration cap; or the caller's live mask) keeps
//      its state, K included.
//
// The new state is written IN PLACE into the loop's state buffers: a lane
// reads all of its old values (the gradient metric reads the old U, the
// residuals the old multipliers and penalties) before it writes any, with a
// barrier between. So the copy of every state leaf after the body is gone,
// and a frozen lane writes nothing at all. With `counts` the kernel also adds
// the lanes live on entry (counts[0], on the replay's first pass) and after
// the pass (counts[1], on its last) to the two int32 counts the loop graph
// copies to the host: integer atomics, exact.
//
// Arithmetic: every decision (the rung, accepted, the stop tests, round_end,
// converged, done) comes out as the PyTorch tail's on the same inputs. The
// scalar steps are written with round-to-nearest intrinsics, so nothing is
// contracted into an FMA that PyTorch rounds twice, and max is NaN
// propagating as torch.amax is. The one difference is the order of the
// residual sums: each row is one fixed-order FMA chain over x, then one over
// u, against cuBLAS's einsum (and an SOC block's |v| summed row by row).
//
// Thread mapping: one block per lane, a thread per (knot, constraint block)
// item; an SOC item computes its block's rows twice (the norms, then each
// row's projection) rather than staging them. Reductions by shuffle, then
// across the block's warps in shared memory.
//
// What bounds it on the H100: latency, not bytes or FLOPs. At the rocket
// window (N=21, n=6, m=3, 15 rows, L=6) a lane moves ~12 KB (the adopted
// rung's X and U, K, the multipliers read and written, its 315 residual
// rows' data from L1): at B=1024 ~12 MB, 4 us at 3.35 TB/s, and ~0.01
// GFLOP; a block's chain of dependent loads and two block reductions sets
// its time.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// IEEE round-to-nearest steps that nvcc does not contract into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
// torch.isfinite
__device__ __forceinline__ bool finite(float a) {
  return fabsf(a) < __int_as_float(0x7f800000);
}
__device__ __forceinline__ bool finite(double a) {
  return fabs(a) < __longlong_as_double(0x7ff0000000000000LL);
}

// torch.maximum / torch.minimum: a NaN operand wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// The constraint blocks (ops/blocks.py's table) with each block's per-lane
// multipliers [Bt, N, p] and penalties [Bt, N], both written in place.
template <typename T>
struct Blocks {
  int nb;
  int row0[altro::kMaxBlocks], p[altro::kMaxBlocks], cone[altro::kMaxBlocks];
  T* lam[altro::kMaxBlocks];
  T* rho[altro::kMaxBlocks];
};

template <typename T>
struct Tail {
  // the loop state, read and then written in place
  T *X, *U, *K, *reg, *grad, *viol;
  int *it_rd, *it, *rounds;
  bool* done;
  Blocks<T> blocks;
  // the pass's inputs
  const T *Knew, *dff, *dV1, *dV2, *Xts, *Uts, *Jts;
  const T *Cx, *Cu, *cb, *cmask;
  const bool* live;  // the caller's live mask, or null: the lane's own cond
  const int* cap;    // the 0-d iteration cap, or null: cap_value
  int* counts;       // the replay's live counts, or null
  int cap_value, count_in, count_out;
  T alpha[altro::kMaxRungs];
  int L;
  // the options
  T grad_tol, min_ratio, reg_min, reg_max, reg_inc, reg_dec, cost_tol,
      eet,  // early_exact_tol, or -1 where it is off
      con_tol, pen_scale, pen_max;
  int inner, outer;
  int N, n, m, P;
};

// the block's NaN-propagating max of v, in every thread
template <typename T>
__device__ T block_max(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  const int warps = blockDim.x / 32;
  __syncthreads();  // an earlier reduction's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < warps; ++w) v = nan_max(v, red[w]);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) al_pass_tail_kernel(Tail<T> a) {
  __shared__ T red[kMaxThreads / 32];
  __shared__ Blocks<T> tab;  // indexed by block: not from the parameters
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, N1 = a.N - 1, n = a.n, m = a.m, P = a.P, L = a.L;

  // 9. the lane's own loop condition on the state it enters with
  const int it = a.it[b], rounds = a.rounds[b], it_rd = a.it_rd[b];
  const int cap = a.cap ? *a.cap : a.cap_value;
  const bool cond = !a.done[b] && rounds < a.outer && it < cap;
  const bool live = a.live ? a.live[b] : cond;
  if (!live) {  // frozen: the state stays as it is
    if (tid == 0 && a.counts && a.count_out && cond)
      atomicAdd(a.counts + 1, 1);
    return;
  }
  if (tid == 0 && a.counts && a.count_in) atomicAdd(a.counts, 1);
  if (tid == 0) tab = a.blocks;  // block_max's barriers show it
  const T reg = a.reg[b], dV1 = a.dV1[b], dV2 = a.dV2[b];

  // 1. the gradient metric: max over knots of |d_k| / (|u_k| + 1)
  T g = T(0);
  for (int k = tid; k < N1; k += nt) {
    const T* dk = a.dff + ((size_t)b * N1 + k) * m;
    const T* uk = a.U + ((size_t)b * N1 + k) * m;
    T md = abs_of(dk[0]), mu = abs_of(uk[0]);
    for (int j = 1; j < m; ++j) {
      md = nan_max(md, abs_of(dk[j]));
      mu = nan_max(mu, abs_of(uk[j]));
    }
    g = nan_max(g, div_rn(md, add_rn(mu, T(1))));
  }
  const T grad_new = block_max(g, red);  // the barrier: U is read
  const bool pre_done = grad_new < a.grad_tol;

  // 2. the rung: every thread scans the ladder (L <= 32) itself
  const T* Jl = a.Jts + (size_t)b * L;
  const T J = Jl[L - 1];
  const T tiny = T(1e-12);
  int idx = -1;
  T e0 = T(0), r0 = T(0), Jn = J;
#pragma unroll
  for (int l = 0; l < altro::kMaxRungs; ++l) {
    if (l < L) {
      const T al = a.alpha[l], Jr = Jl[l];
      const T e = -add_rn(mul_rn(al, dV1), mul_rn(mul_rn(al, al), dV2));
      const T r = div_rn(sub_rn(J, Jr), nan_max(e, tiny));
      if (l == 0) {
        e0 = e;
        r0 = r;
      }
      const bool ok = (e > tiny ? r > a.min_ratio : Jr < J) && finite(Jr);
      if (ok && idx < 0) {
        idx = l;
        Jn = Jr;
      }
    }
  }
  const bool accepted = idx >= 0;
  if (!accepted) idx = 0;

  // 5. the regularization schedule
  const T up = nan_min(nan_max(mul_rn(nan_max(reg, a.reg_min), a.reg_inc),
                               a.reg_min),
                       a.reg_max);
  const T down = mul_rn(reg, a.reg_dec);
  const T reg_new = accepted ? (down < a.reg_min ? T(0) : down) : up;

  // 6. the stop tests
  const T dJ = sub_rn(J, Jn);
  const bool stuck = !accepted && reg >= a.reg_max;
  const bool exact_full = accepted && idx == 0 && e0 > tiny &&
                          abs_of(sub_rn(r0, T(1))) <= a.eet;
  const bool inner_done =
      pre_done || (accepted && dJ < a.cost_tol) || stuck || exact_full;
  const bool round_end = inner_done || it_rd + 1 >= a.inner;
  const bool lam_new = round_end && (accepted || pre_done);

  // 3. the adopted trajectory; the state takes it (the residuals below read
  // the rung, or the kept trajectory, which is then not written)
  const T* Xa = accepted ? a.Xts + ((size_t)b * L + idx) * N * n
                         : a.X + (size_t)b * N * n;
  const T* Ua = accepted ? a.Uts + ((size_t)b * L + idx) * N1 * m
                         : a.U + (size_t)b * N1 * m;
  if (accepted) {
    for (int e = tid; e < N * n; e += nt) a.X[(size_t)b * N * n + e] = Xa[e];
    for (int e = tid; e < N1 * m; e += nt)
      a.U[(size_t)b * N1 * m + e] = Ua[e];
  }
  for (int e = tid; e < N1 * m * n; e += nt)
    a.K[(size_t)b * N1 * m * n + e] = a.Knew[(size_t)b * N1 * m * n + e];

  // 4. and 7. the residuals and projected multipliers of each (knot, block)
  auto residual = [&](int k, int rr) {
    const T* cx = a.Cx + ((size_t)k * P + rr) * n;
    const T* xk = Xa + (size_t)k * n;
    T ax = T(0), au = T(0);
    for (int j = 0; j < n; ++j) ax = fma_rn(cx[j], xk[j], ax);
    if (k < N1) {
      const T* cu = a.Cu + ((size_t)k * P + rr) * m;
      const T* uk = Ua + (size_t)k * m;
      for (int j = 0; j < m; ++j) au = fma_rn(cu[j], uk[j], au);
    }
    return add_rn(add_rn(ax, au), a.cb[(size_t)k * P + rr]);
  };
  T vmax = T(0);
  const int nb = tab.nb;
  for (int t = tid; t < N * nb; t += nt) {
    const int k = t / nb, bi = t % nb;
    const int r0w = tab.row0[bi], p = tab.p[bi], cone = tab.cone[bi];
    const T rho = tab.rho[bi][(size_t)b * N + k];
    T* lam = tab.lam[bi] + ((size_t)b * N + k) * p;
    const T mask = a.cmask[(size_t)k * P + r0w];
    // an SOC block's norms |v| of z and of c, and their last rows s
    T az = T(0), sz = T(0), ac = T(0), sc = T(0);
    if (cone == altro::kSoc) {
      for (int r = 0; r < p; ++r) {
        const T c = residual(k, r0w + r);
        const T z = add_rn(lam[r], mul_rn(rho, c));
        if (r < p - 1) {
          az = add_rn(az, mul_rn(z, z));
          ac = add_rn(ac, mul_rn(c, c));
        } else {
          sz = z;
          sc = c;
        }
      }
      az = sqrt_rn(az);
      ac = sqrt_rn(ac);
    }
    // proj_soc's row r of w = (v, s) with |v| = aw: inside, polar, boundary
    auto soc = [&](T w, bool last, T aw, T sw) {
      const T safe = aw > T(0) ? aw : T(1);
      const T scale = div_rn(add_rn(aw, sw), mul_rn(T(2), safe));
      const T bnd = mul_rn(scale, last ? aw : w);
      return aw <= sw ? w : (aw <= -sw ? T(0) : bnd);
    };
    for (int r = 0; r < p; ++r) {
      const T c = residual(k, r0w + r);
      const T z = add_rn(lam[r], mul_rn(rho, c));
      T ct, v;
      if (cone == altro::kZero) {
        ct = z;
        v = sub_rn(c, T(0));
      } else if (cone == altro::kNonpos) {
        ct = nan_max(z, T(0));
        v = sub_rn(c, nan_min(c, T(0)));
      } else {
        const bool last = r == p - 1;
        ct = sub_rn(z, soc(z, last, az, sz));
        v = sub_rn(c, soc(c, last, ac, sc));
      }
      vmax = nan_max(vmax, abs_of(mask > T(0) ? v : T(0)));
      if (lam_new) lam[r] = mul_rn(ct, mask);
    }
  }
  const T viol_r = block_max(vmax, red);  // the barrier: rho is read
  const bool converged = viol_r < a.con_tol;
  if (round_end && !converged) {
    for (int t = tid; t < N * nb; t += nt) {
      T* rho = tab.rho[t % nb] + (size_t)b * N + t / nb;
      *rho = nan_min(mul_rn(*rho, a.pen_scale), a.pen_max);
    }
  }

  // 8. the counters and flags
  if (tid == 0) {
    const bool done = round_end && converged;
    const int rounds_new = rounds + (round_end ? 1 : 0);
    a.reg[b] = reg_new;
    a.grad[b] = grad_new;
    if (round_end) a.viol[b] = viol_r;
    a.it_rd[b] = round_end ? 0 : it_rd + 1;
    a.it[b] = it + 1;
    a.rounds[b] = rounds_new;
    a.done[b] = done;
    if (a.counts && a.count_out && !done && rounds_new < a.outer &&
        it + 1 < cap)
      atomicAdd(a.counts + 1, 1);
  }
}

// ptrs: X U K reg grad viol it_rd it rounds done | Knew dff dV1 dV2 Xts Uts
// Jts | Cx Cu b mask | live cap counts (the last three may be null);
// ints: Bt N n m P L inner outer cap_value count_in count_out;
// reals: grad_tol min_ratio reg_min reg_max reg_inc reg_dec cost_tol eet
// con_tol pen_scale pen_max, then the L step sizes.
template <typename T>
int launch_pass_tail(void* const* ptrs, const int* ints, const double* reals,
                     int nblocks, const int* meta, const void* const* lams,
                     const void* const* rhos, void* stream) {
  const int Bt = ints[0], N = ints[1], n = ints[2], m = ints[3], P = ints[4],
            L = ints[5];
  if (Bt < 1 || N < 2 || n < 1 || m < 1 || n > altro::kMaxDim ||
      m > altro::kMaxDim || P < 0 || P > altro::kMaxRows || L < 1 ||
      L > altro::kMaxRungs)
    return (int)cudaErrorInvalidValue;
  altro::BlockTable<T> tab;
  if (!altro::make_table(nblocks, meta, lams, P, &tab))
    return (int)cudaErrorInvalidValue;
  Tail<T> a;
  T** state = reinterpret_cast<T**>(const_cast<void**>(ptrs));
  a.X = state[0];
  a.U = state[1];
  a.K = state[2];
  a.reg = state[3];
  a.grad = state[4];
  a.viol = state[5];
  a.it_rd = static_cast<int*>(ptrs[6]);
  a.it = static_cast<int*>(ptrs[7]);
  a.rounds = static_cast<int*>(ptrs[8]);
  a.done = static_cast<bool*>(ptrs[9]);
  a.Knew = state[10];
  a.dff = state[11];
  a.dV1 = state[12];
  a.dV2 = state[13];
  a.Xts = state[14];
  a.Uts = state[15];
  a.Jts = state[16];
  a.Cx = state[17];
  a.Cu = state[18];
  a.cb = state[19];
  a.cmask = state[20];
  a.live = static_cast<const bool*>(ptrs[21]);
  a.cap = static_cast<const int*>(ptrs[22]);
  a.counts = static_cast<int*>(ptrs[23]);
  a.blocks.nb = nblocks;
  for (int i = 0; i < altro::kMaxBlocks; ++i) {
    a.blocks.lam[i] = i < nblocks ? const_cast<T*>(tab.lam[i]) : nullptr;
    a.blocks.rho[i] =
        i < nblocks ? static_cast<T*>(const_cast<void*>(rhos[i])) : nullptr;
    a.blocks.row0[i] = tab.row0[i];
    a.blocks.p[i] = tab.p[i];
    a.blocks.cone[i] = tab.cone[i];
  }
  a.L = L;
  a.inner = ints[6];
  a.outer = ints[7];
  a.cap_value = ints[8];
  a.count_in = ints[9];
  a.count_out = ints[10];
  a.N = N;
  a.n = n;
  a.m = m;
  a.P = P;
  a.grad_tol = (T)reals[0];
  a.min_ratio = (T)reals[1];
  a.reg_min = (T)reals[2];
  a.reg_max = (T)reals[3];
  a.reg_inc = (T)reals[4];
  a.reg_dec = (T)reals[5];
  a.cost_tol = (T)reals[6];
  a.eet = reals[7] > 0.0 ? (T)reals[7] : T(-1);  // off: no ratio passes
  a.con_tol = (T)reals[8];
  a.pen_scale = (T)reals[9];
  a.pen_max = (T)reals[10];
  for (int i = 0; i < altro::kMaxRungs; ++i)
    a.alpha[i] = i < L ? (T)reals[11 + i] : T(0);
  // a thread per (knot, block) item, in whole warps
  const int items = N * nblocks;
  const int threads =
      std::min(kMaxThreads, std::max(32, (items + 31) / 32 * 32));
  al_pass_tail_kernel<T>
      <<<(unsigned)Bt, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define ALTRO_TAIL_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* const* ptrs, const int* ints,                    \
                      const double* reals, int nblocks, const int* meta,     \
                      const void* const* lams, const void* const* rhos,      \
                      void* stream) {                                        \
    return launch_pass_tail<T>(ptrs, ints, reals, nblocks, meta, lams, rhos, \
                               stream);                                      \
  }

ALTRO_TAIL_ENTRY(altro_pass_tail_f32, float)
ALTRO_TAIL_ENTRY(altro_pass_tail_f64, double)
