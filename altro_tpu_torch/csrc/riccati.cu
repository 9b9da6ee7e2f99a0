// Batched Riccati backward pass from precomputed per-lane expansions.
//
// Replaces the TPU kernel altro_tpu/ops/riccati.py: batched_riccati (Pallas
// body `_kernel`). For every scenario, from the terminal knot backwards:
//
//   Vx = lx[N-1], Vxx = lxx[N-1]
//   Qx = lx + A'Vx,  Qu = lu + B'Vx,  Qxx = lxx + A'Vxx A,
//   Quu = luu + B'Vxx B,  Qux = lux + B'Vxx A
//   L L' = Quu + reg I (pivots clamped as sqrt(max(., 1e-12)), NaN kept)
//   (K | d) = -(L L')^-1 (Qux | Qu)
//   Vx  = Qx + K'(Quu d + Qu) + Qux'd
//   Vxx = Qxx + K'Quu K + K'Qux + Qux'K   (upper triangle, mirrored)
//   dV1 += d'Qu,  dV2 += d'Quu d / 2
//
// writing K [Bt, N-1, m, n], d [Bt, N-1, m], dV1, dV2 [Bt]. A [N-1, n, n]
// and B [N-1, n, m] are shared (per_lane = 0, read with a lane stride of 0)
// or per scenario [Bt, N-1, ...]; the expansions lx [Bt, N, n],
// lu [Bt, N, m], lxx [Bt, N, n, n], luu [Bt, N, m, m], lux [Bt, N, m, n]
// are per scenario (their terminal control rows are not read).
//
// Thread mapping: one warp per scenario, SPB scenarios (warps) per block.
// The TPU grid's sequential knot axis, whose value-function carry lived in
// VMEM scratch, is a loop inside the warp. Each warp stages its knot's A and
// B in shared memory (every product reads them n times) and keeps Vx/Vxx,
// the Q blocks, the Cholesky factor and the gains there too (1,644 values
// at n = m = 12: 6.6 KB in f32, 13 KB in f64), spreading the elements of every product over its
// 32 lanes; the expansions are read from device memory where they are used,
// once each, by neighbouring lanes at neighbouring addresses. The Cholesky
// pivots and the dV sums run on lane 0; the n+1 triangular solves run one
// column per lane. The arithmetic is that of kernel B's Riccati tail
// (riccati_fused.cu), copied so that B stays exactly as it is.
//
// What bounds it on the H100: at the quadruped's N = 15, n = m = 12 a
// scenario brings about 10.6k values per call (A, B, luu, lux on 14 knots,
// lxx, lx, lu on 15): ~43 MB at B = 1024 in f32, ~13 us of HBM time. The
// FLOPs are few (~36 kFLOP per scenario-knot). Unlike kernel B nothing is
// shared between scenarios, so nothing is staged once per block; the serial
// chain of ~12 warp synchronisations and short shared-memory dot products
// per knot bounds it, as it bounds B. B = 1024 gives 256 blocks of 4 warps.
#include <cstdint>

#include "common.cuh"

namespace {

// One scenario's shared-memory work space, in elements:
//   A[n*n] B[n*m] Vx[n] Vxx[n*n] Qx[n] Qu[m] Qxx[n*n] Quu[m*m] Qux[m*n]
//   VA[n*n] VB[n*m] L[m*m] KD[(n+1)*m] Quud[m] QuuK[m*n]
__host__ __device__ inline int warp_elems(int n, int m) {
  return 4 * n * n + 3 * n * m + 2 * m * m + 2 * n + 2 * m + (n + 1) * m +
         m * n;
}

template <typename T>
__global__ void riccati_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, int per_lane,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int N, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int spb = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * spb + warp;
  if (b >= Bt) return;  // no block-wide barrier below: a warp may leave
  const int N1 = N - 1;

  T* sA = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(n, m);
  T* sB = sA + n * n;
  T* Vx = sB + n * m;
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

  const size_t dyn_lane = per_lane ? (size_t)b : 0;
  const T regb = reg[b];

  // ---------------- terminal knot
  {
    const T* lxk = lx + ((size_t)b * N + N1) * n;
    const T* lxxk = lxx + ((size_t)b * N + N1) * n * n;
    for (int i = lane; i < n; i += 32) Vx[i] = lxk[i];
    for (int e = lane; e < n * n; e += 32) Vxx[e] = lxxk[e];
    __syncwarp();
  }

  T dv1 = T(0), dv2 = T(0);
  // ---------------- knots N-2 .. 0
  for (int k = N1 - 1; k >= 0; --k) {
    const T* Ak = A + (dyn_lane * N1 + k) * n * n;
    const T* Bk = Bm + (dyn_lane * N1 + k) * n * m;
    for (int e = lane; e < n * n; e += 32) sA[e] = Ak[e];
    for (int e = lane; e < n * m; e += 32) sB[e] = Bk[e];
    __syncwarp();

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
    const size_t kn = (size_t)b * N + k;
    for (int i = lane; i < n; i += 32) {
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += sA[p * n + i] * Vx[p];
      Qx[i] = lx[kn * n + i] + acc;
    }
    for (int i = lane; i < m; i += 32) {
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += sB[p * m + i] * Vx[p];
      Qu[i] = lu[kn * m + i] + acc;
    }
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e % n;
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += sA[p * n + i] * VA[p * n + j];
      Qxx[e] = lxx[kn * n * n + e] + acc;
    }
    for (int e = lane; e < m * m; e += 32) {
      const int i = e / m, j = e % m;
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += sB[p * m + i] * VB[p * m + j];
      Quu[e] = luu[kn * m * m + e] + acc;
    }
    for (int e = lane; e < m * n; e += 32) {
      const int i = e / n, j = e % n;
      T acc = T(0);
      for (int p = 0; p < n; ++p) acc += sB[p * m + i] * VA[p * n + j];
      Qux[e] = lux[kn * m * n + e] + acc;
    }
    __syncwarp();

    // Cholesky of Quu + reg I, column by column; the pivot clamp keeps a
    // NaN, as jnp.maximum does
    for (int j = 0; j < m; ++j) {
      if (lane == 0) {
        T dg = Quu[j * m + j] + regb;
        for (int p = 0; p < j; ++p) dg -= Lc[j * m + p] * Lc[j * m + p];
        const T dgc = dg > T(1e-12) || dg != dg ? dg : T(1e-12);
        Lc[j * m + j] = sqrt(dgc);
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

  if (lane == 0) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
}

template <typename T>
int launch_riccati(const void* A, const void* Bm, int per_lane,
                   const void* lx, const void* lu, const void* lxx,
                   const void* luu, const void* lux, const void* reg,
                   void* K, void* d, void* dV1, void* dV2, int Bt, int N,
                   int n, int m, void* stream) {
  if (n < 1 || m < 1 || n > altro::kMaxDim || m > altro::kMaxDim || N < 2 ||
      Bt < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem_cap = 232448;  // 227 KB opt-in limit
  int spb = 4;
  size_t bytes = 0;
  for (;;) {
    bytes = (size_t)spb * warp_elems(n, m) * sizeof(T);
    if (bytes <= smem_cap || spb == 1) break;
    spb /= 2;
  }
  if (bytes > smem_cap) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        riccati_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((Bt + spb - 1) / spb);
  riccati_kernel<T><<<blocks, 32 * spb, bytes, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)Bm, per_lane, (const T*)lx, (const T*)lu,
      (const T*)lxx, (const T*)luu, (const T*)lux, (const T*)reg, (T*)K,
      (T*)d, (T*)dV1, (T*)dV2, Bt, N, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

#define ALTRO_RICCATI_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* A, const void* Bm, int per_lane,           \
                      const void* lx, const void* lu, const void* lxx,       \
                      const void* luu, const void* lux, const void* reg,     \
                      void* K, void* d, void* dV1, void* dV2, int Bt, int N, \
                      int n, int m, void* stream) {                          \
    return launch_riccati<T>(A, Bm, per_lane, lx, lu, lxx, luu, lux, reg, K, \
                             d, dV1, dV2, Bt, N, n, m, stream);              \
  }

ALTRO_RICCATI_ENTRY(altro_riccati_f32, float)
ALTRO_RICCATI_ENTRY(altro_riccati_f64, double)
