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
// and B [N-1, n, m] are shared (per_lane = 0) or per scenario
// [Bt, N-1, ...]; the expansions lx [Bt, N, n], lu [Bt, N, m],
// lxx [Bt, N, n, n], luu [Bt, N, m, m], lux [Bt, N, m, n] are per scenario
// (their terminal control rows are not read). Below the terminal knot only
// the upper triangle of lxx and the lower triangle of luu enter the result
// (the plain version's Cholesky reads the lower triangle of Quu too).
//
// Thread mapping (kernel B's Riccati tail, riccati_fused.cu, with the
// expansion read instead of formed, and the products in tiles): a group of
// TG threads works one scenario, 64 while n, m <= 16 and the factor's rows
// fit a warp (see pass 3), 128 above; a block of 256 threads holds 256 / TG
// groups, and each group syncs on its own named barrier (bar.sync
// 1 + group, TG). The TPU grid's sequential knot axis is a loop inside the
// group.
//
// What bounds it on the H100: at the quadruped's B = 1024, N = 15,
// n = m = 12 it moves ~53.5 MB in f32 (A, B, luu, lux on 14 knots, lxx on 15,
// K written): 16 us at 3.35 TB/s, against ~0.52 GFLOP (8 us at 67 TFLOP/s),
// so the bytes bound it. What it reaches is the LATENCY OF ONE GROUP'S KNOT:
// one group per SM takes as long as eight, and the lone warp that a pass
// leaves busy starts an instruction every ~5 cycles. So the design counts
// instructions on the knot's critical path:
//
// - every matrix of a group lies in a SLOT of shared memory of one size
//   (max(n, m rounded up to 4) rows of ld = max(n, m) rounded up to 4
//   entries) and the vectors are rows of one more slot, so an address is
//   slot number x slot size + row x ld + column from three registers. With
//   one pointer per matrix the compiler, at the 128 registers that let 8
//   groups share an SM, rebuilt the pointers in chains of integer additions
//   before every access;
// - the row stride of 4 lets a thread compute a TILE of 4 neighbouring
//   entries of a row from one scalar and one 16- or 32-byte vector load per
//   term (two loads per 4 multiply-adds, where one entry per thread takes
//   eight);
// - the slots start at zero and only zeros ever reach their padding, so the
//   factorization and the solves run over the padded width MM = m rounded
//   up to 4 (a compile-time 4, 8, 12 or 16; the padding of Quu is the
//   identity) without a guard on m: any m <= 16 takes this body, and the
//   guarded form of it took three times the instructions.
//
// Per knot:
//
//   staging  the group copies its scenario's rows of knot k-1 (lx lu lxx luu
//            lux, and A B when they are per scenario) by cp.async into its
//            own double buffer while it computes knot k, each element to its
//            place through a table of offsets made once per block. With
//            per-scenario dynamics nothing is shared, so a group waits for
//            no other group. Shared A and B are staged once per block, and
//            the knot then starts on a __syncthreads instead of the group's
//            barrier;
//   pass 1   V A and V B, one tile per thread and round;
//   pass 2   every tile of Qxx (the tiles that touch the upper triangle),
//            Qx, Qux, Qu, Quu (the lower triangle) at once: each thread OWNS
//            fixed tiles of Qxx and Qx and keeps them in registers until it
//            turns them into its tiles of Vxx and Vx; the others go to
//            shared memory (Quu to both halves). The tiles are listed in a
//            table of codes made once per block; the matrix kinds share one
//            loop body and Qx, Qu another;
//   pass 3   the group's first warp factors Quu + reg I and runs the forward
//            substitution in the same sweep: lane i < MM holds row i in its
//            registers, lane MM + c column c of -(Qux | Qu) as one more row
//            (MM + n + 1 <= 32 lanes; shuffles, no barrier per column). Then
//            n + 1 threads each run the back substitution of one column of
//            (K | d) in registers, reading the rows of L' as vectors, and
//            form its column of Quu K (the d thread: Quu d and both dV sums,
//            in registers across knots). The groups of 128 factor column by
//            column in shared memory and solve there instead;
//   pass 4   the owners form Vxx (upper triangle, written to both halves
//            before the barrier that ends the knot) and Vx; K and d are
//            stored coalesced.
//
// Four group barriers per knot. n stays a run-time width.
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"
#include "wide.cuh"

namespace {

constexpr int kBlockThreads = 256;
// Widest n and m that a group of 64 threads takes, and the widest row the
// shuffle factorization keeps in registers.
constexpr int kSmallDim = 16;
constexpr unsigned kFull = 0xffffffffu;

// Slots of a knot's staged rows: the vectors (rows lx, lu), lxx, luu, lux,
// then A and B (the group's with per-scenario dynamics, else the block's).
constexpr int kStageSlots = 4;
constexpr int kDynSlots = 2;
// Slots of a group's work space: the vectors (rows Vx, Qu, Quu d, d and the
// pivots' reciprocals), Vxx, Quu, Qux, V A, V B, Quu K, K and the Cholesky
// factor (L' by rows from the shuffle factorization, L by rows from the
// generic one).
constexpr int kVecRows = 5;
constexpr int kWorkSlots = 9;

// Row stride and slot size, in elements.
__host__ __device__ inline int row_stride(int n, int m) {
  return ((n > m ? n : m) + 3) & ~3;
}
__host__ __device__ inline int slot_elems(int n, int m) {
  const int m4 = (m + 3) & ~3;  // the factor's padded rows
  const int rows = n > m4 ? n : m4;
  return (rows > kVecRows ? rows : kVecRows) * row_stride(n, m);
}

// One group's shared memory, in slots: two staging buffers and the work
// space.
__host__ __device__ inline int group_slots(int per_lane) {
  return 2 * (kStageSlots + (per_lane ? kDynSlots : 0)) + kWorkSlots;
}

// Source elements of a scenario's knot, in staging order:
// lx lxx lu luu lux A B.
__host__ __device__ inline int source_elems(int n, int m) {
  return n + n * n + m + m * m + m * n + n * n + n * m;
}

// Tiles of 4 entries that touch the upper, or the lower, triangle of a
// w x w matrix.
__host__ __device__ inline int upper_tiles(int w) {
  int count = 0;
  for (int i = 0; i < w; ++i) count += (w + 3) / 4 - i / 4;
  return count;
}
__host__ __device__ inline int lower_tiles(int w) {
  int count = 0;
  for (int i = 0; i < w; ++i) count += i / 4 + 1;
  return count;
}

// Pass-1 tiles: V A, then V B. Pass-2 tiles: Qxx (upper), Qx, Qux, Qu,
// Quu (lower); the first owned_tiles(n) stay in their thread's registers.
__host__ __device__ inline int pass1_tiles(int n, int m) {
  return n * ((n + 3) / 4 + (m + 3) / 4);
}
__host__ __device__ inline int owned_tiles(int n) {
  return upper_tiles(n) + (n + 3) / 4;
}
__host__ __device__ inline int pass2_tiles(int n, int m) {
  return owned_tiles(n) + m * ((n + 3) / 4) + (m + 3) / 4 + lower_tiles(m);
}

// A knot's staged rows and the group's work space: a base pointer each and
// the two strides; every matrix is a slot, every vector a row of slot 0.
template <typename T>
struct Space {
  const T* st;   // the knot's staging buffer
  const T* dyn;  // A, then B
  T* w;          // the work space
  int ld, slot;
  __device__ __forceinline__ const T* lx() const { return st; }
  __device__ __forceinline__ const T* lu() const { return st + ld; }
  __device__ __forceinline__ const T* lxx() const { return st + slot; }
  __device__ __forceinline__ const T* luu() const { return st + 2 * slot; }
  __device__ __forceinline__ const T* lux() const { return st + 3 * slot; }
  __device__ __forceinline__ const T* A() const { return dyn; }
  __device__ __forceinline__ const T* B() const { return dyn + slot; }
  __device__ __forceinline__ T* Vx() const { return w; }
  __device__ __forceinline__ T* Qu() const { return w + ld; }
  __device__ __forceinline__ T* Quud() const { return w + 2 * ld; }
  __device__ __forceinline__ T* d() const { return w + 3 * ld; }
  __device__ __forceinline__ T* Linv() const { return w + 4 * ld; }
  __device__ __forceinline__ T* Vxx() const { return w + slot; }
  __device__ __forceinline__ T* Quu() const { return w + 2 * slot; }
  __device__ __forceinline__ T* Qux() const { return w + 3 * slot; }
  __device__ __forceinline__ T* VA() const { return w + 4 * slot; }
  __device__ __forceinline__ T* VB() const { return w + 5 * slot; }
  __device__ __forceinline__ T* QuuK() const { return w + 6 * slot; }
  __device__ __forceinline__ T* K() const { return w + 7 * slot; }
  __device__ __forceinline__ T* factor() const { return w + 8 * slot; }
};

// Four neighbouring entries, 16-byte aligned, as one or two vector accesses.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Where source element e of a knot (source_elems order) goes: its offset in
// the scenario's staging buffer, or for A and B with shared dynamics in the
// block's.
__device__ __forceinline__ int staged_offset(int e, int n, int m,
                                             int per_lane) {
  const int ld = row_stride(n, m), slot = slot_elems(n, m);
  const int w[7] = {n, n, m, m, n, n, m};  // row widths
  const int rows[7] = {1, n, 1, m, m, n, n};
  const int base[7] = {0, slot, ld, 2 * slot, 3 * slot,
                       per_lane ? kStageSlots * slot : 0,
                       (per_lane ? kStageSlots * slot : 0) + slot};
#pragma unroll
  for (int a = 0; a < 7; ++a) {
    if (e < rows[a] * w[a]) return base[a] + e / w[a] * ld + e % w[a];
    e -= rows[a] * w[a];
  }
  return 0;
}

// Tile e of the upper triangle of a w x w matrix, row by row:
// code = jb << 8 | i for the 4 entries (i, 4 jb .. 4 jb + 3).
__device__ __forceinline__ int upper_tile(int e, int w) {
  const int nb = (w + 3) / 4;
  int i = 0;
  while (e >= nb - i / 4) {
    e -= nb - i / 4;
    ++i;
  }
  return (i / 4 + e) << 8 | i;
}

// Tile e of the lower triangle, likewise.
__device__ __forceinline__ int lower_tile(int e, int w) {
  int i = 0;
  while (e >= i / 4 + 1) {
    e -= i / 4 + 1;
    ++i;
  }
  return e << 8 | i;
}

// Tile codes, kind << 16 | jb << 8 | i. Pass 1: kind 0 V A, 1 V B.
__device__ __forceinline__ int pass1_code(int e, int n, int m) {
  const int nb = (n + 3) / 4, mb = (m + 3) / 4;
  if (e < n * nb) return (e % nb) << 8 | e / nb;
  e -= n * nb;
  return 1 << 16 | (e % mb) << 8 | e / mb;
}

// Pass 2: kind 0 Qxx, 1 Qx, 2 Qux, 3 Qu, 4 Quu.
__device__ __forceinline__ int pass2_code(int e, int n, int m) {
  const int nb = (n + 3) / 4, mb = (m + 3) / 4;
  if (e < upper_tiles(n)) return upper_tile(e, n);
  if ((e -= upper_tiles(n)) < nb) return 1 << 16 | e << 8;
  if ((e -= nb) < m * nb) return 2 << 16 | (e % nb) << 8 | e / nb;
  if ((e -= m * nb) < mb) return 3 << 16 | e << 8;
  return 4 << 16 | lower_tile(e - mb, m);
}

// The pass-2 tile of a code: its four entries to v, and to shared memory
// unless it is owned (Qxx, Qx). The three matrix kinds share one loop body,
// and Qx, Qu another, with their operands picked by pointer, so a warp that
// holds several kinds runs each body once.
template <typename T>
__device__ __forceinline__ void q_tile(const Space<T>& sp, int n, int m,
                                       int code, T* v) {
  const int ld = sp.ld;
  const int kind = code >> 16, i = code & 255, j = 4 * ((code >> 8) & 255);
  T dv[4] = {T(0), T(0), T(0), T(0)}, t4[4];
  if (kind == 1 || kind == 3) {
    // Qx = lx + A'Vx;  Qu = lu + B'Vx
    const bool xr = kind == 1;
    const T* D = (xr ? sp.A() : sp.B()) + j;
    const T* Vx = sp.Vx();
#pragma unroll 4
    for (int p = 0; p < n; ++p) {
      const T x = Vx[p];
      load4(D + p * ld, t4);
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] += t4[q] * x;
    }
    load4((xr ? sp.lx() : sp.lu()) + j, t4);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = t4[q] + dv[q];
    if (!xr) store4(sp.Qu() + j, v);
    return;
  }
  // Qxx = lxx + A'V A;  Qux = lux + B'V A;  Quu = luu + B'V B
  const T* D = (kind == 0 ? sp.A() : sp.B()) + i;
  const T* V = (kind == 4 ? sp.VB() : sp.VA()) + j;
#pragma unroll 4
  for (int p = 0; p < n; ++p) {
    const T x = D[p * ld];
    load4(V + p * ld, t4);
#pragma unroll
    for (int q = 0; q < 4; ++q) dv[q] += x * t4[q];
  }
  load4((kind == 0 ? sp.lxx() : kind == 2 ? sp.lux() : sp.luu()) + i * ld + j,
        t4);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = t4[q] + dv[q];
  if (kind == 2) store4(sp.Qux() + i * ld + j, v);
  if (kind == 4) {
    T* Quu = sp.Quu();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = j + q;
      if (c <= i) Quu[i * ld + c] = Quu[c * ld + i] = v[q];
    }
  }
}

// sqrt(max(dg, 1e-12)) that keeps a NaN, as jnp.maximum does
template <typename T>
__device__ __forceinline__ T clamp_pivot(T dg) {
  return dg > T(1e-12) || dg != dg ? dg : T(1e-12);
}

// d = sqrt(x) and 1 / d for a pivot x >= 1e-12 or NaN. float: both from one
// reciprocal square root refined by a Newton step each, a third of the
// dependent latency of an IEEE square root followed by an IEEE division,
// which is what the columns of the factorization wait for; double: the
// IEEE pair.
__device__ __forceinline__ void root_and_inverse(float x, float* d,
                                                 float* inv) {
  const float r = rsqrtf(x);
  const float d0 = x * r;
  *d = fmaf(fmaf(-d0, d0, x), 0.5f * r, d0);
  *inv = fmaf(fmaf(-*d, r, 1.0f), r, r);
}
__device__ __forceinline__ void root_and_inverse(double x, double* d,
                                                 double* inv) {
  *d = sqrt(x);
  *inv = 1.0 / *d;
}

// s / d from the reciprocal of d: the product corrected by its residual,
// which rounds as the division does but for rare last-bit cases, in three
// dependent operations.
template <typename T>
__device__ __forceinline__ T div_by(T s, T d, T inv) {
  const T q = s * inv;
  return fma(fma(-d, q, s), inv, q);
}

// Quu + reg I = L L' and the forward substitution L Y = -(Qux | Qu) in one
// sweep by the group's first warp: lane i < MM holds row i of the trailing
// matrix in its registers, lane MM + c column c of the right-hand side as
// one more row below it (MM + n + 1 <= 32), and the elimination of column j
// turns that row's entry into Y(j, c), as it turns row i's into L(i, j).
// Per column, one shuffle broadcasts the pivot and each later row's update
// takes that column's entries of the rows above by shuffles; no barrier.
// Summation order as column by column: entry (i, k) subtracts
// L(i, p) L(k, p) for p = 0, 1, ... The matrix is padded from m to MM rows
// with the identity (the padding of every slot is zero, see the kernel), so
// the columns unroll over the constant MM with no guard on m: a guarded
// body took three times the instructions, and a lone warp starts one every
// ~5 cycles. L goes to shared memory transposed (Lt, whose rows the back
// substitution reads as vectors) with the pivots' reciprocals, Y into K's
// and d's places. The lanes past MM + n factor a copy of row 0 and store
// nothing.
template <typename T, int MM>
__device__ __forceinline__ void factor_forward(const Space<T>& sp, T regb,
                                               int n, int m, int lane) {
  const int ld = sp.ld;
  const int c = lane - MM;  // the right-hand side's column, 0 <= c <= n
  const bool rhs = c >= 0 && c <= n;
  // the lane's row: row lane of Quu, column c of Qux, or Qu, by its first
  // entry and the stride between its entries
  const int i = lane < MM ? lane : 0;
  const T* src = rhs ? (c < n ? sp.Qux() + c : sp.Qu()) : sp.Quu() + i * ld;
  const int step = rhs && c < n ? ld : 1;
  const T diag = i < m ? regb : T(1);
  T a[MM];
#pragma unroll
  for (int q = 0; q < MM; ++q) {
    const T v = src[q * step];
    a[q] = rhs ? -v : (q == i ? v + diag : v);
  }
  // where the lane's column entry goes: L'(j, lane), or Y(j, c)
  T* dst = rhs ? (c < n ? sp.K() + c : sp.d()) : sp.factor() + lane;
  const int dstep = rhs && c == n ? 1 : ld;
  T* Linv = sp.Linv();
#pragma unroll
  for (int j = 0; j < MM; ++j) {
    T d, inv;
    root_and_inverse(clamp_pivot(__shfl_sync(kFull, a[j], j)), &d, &inv);
    const T lj = lane == j ? d : div_by(a[j], d, inv);  // L(lane, j), Y(j, c)
    if (rhs || (lane >= j && lane < MM)) dst[j * dstep] = lj;
    if (lane == j) Linv[j] = inv;
#pragma unroll
    for (int k = j + 1; k < MM; ++k) {
      const T lkj = __shfl_sync(kFull, lj, k);  // L(k, j)
      if (lane >= k) a[k] -= lj * lkj;
    }
  }
}

// Column c of (K | d): the back substitution L' X = Y in registers over the
// padded width MM, with the rows of L' read from shared memory as vectors
// (one address for all the solving threads); then its column of Quu K, or,
// for the d column (c = n), Quu d and the dV sums.
template <typename T, int MM>
__device__ __forceinline__ void solve_back(const Space<T>& sp, int n, int c,
                                           T* dv1, T* dv2) {
  const int ld = sp.ld;
  // the column's entries in K or d, and in Quu K or Quu d
  T* out = c < n ? sp.K() + c : sp.d();
  T* prod = c < n ? sp.QuuK() + c : sp.Quud();
  const int step = c < n ? ld : 1;
  const T *Lt = sp.factor(), *Linv = sp.Linv(), *Quu = sp.Quu(),
          *Qu = sp.Qu();
  T col[MM], row[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) col[i] = out[i * step];
#pragma unroll
  for (int i = MM - 1; i >= 0; --i) {
    T s = col[i];
#pragma unroll
    for (int q = i / 4 * 4; q < MM; q += 4) load4(Lt + i * ld + q, row + q);
#pragma unroll
    for (int p = i + 1; p < MM; ++p) s -= row[p] * col[p];
    col[i] = div_by(s, row[i], Linv[i]);
  }
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int i = 0; i < MM; ++i) {
#pragma unroll
    for (int q = 0; q < MM; q += 4) load4(Quu + i * ld + q, row + q);
    T acc = T(0);
#pragma unroll
    for (int p = 0; p < MM; ++p) acc += row[p] * col[p];
    out[i * step] = col[i];
    prod[i * step] = acc;
    s1 += col[i] * Qu[i];
    s2 += col[i] * acc;
  }
  if (c == n) {
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

// The generic width: the group's first warp factors Quu + reg I column by
// column into L (lane 0 the pivots); a group barrier follows.
template <typename T>
__device__ __forceinline__ void factor_warp(const Space<T>& sp, T regb, int m,
                                            int t) {
  if (t >= 32) return;
  const int ld = sp.ld;
  T* L = sp.factor();
  const T* Quu = sp.Quu();
  for (int j = 0; j < m; ++j) {
    if (t == 0) {
      T dg = Quu[j * ld + j] + regb;
      for (int p = 0; p < j; ++p) dg -= L[j * ld + p] * L[j * ld + p];
      L[j * ld + j] = sqrt(clamp_pivot(dg));
    }
    __syncwarp();
    for (int i = j + 1 + t; i < m; i += 32) {
      T s = Quu[i * ld + j];
      for (int p = 0; p < j; ++p) s -= L[i * ld + p] * L[j * ld + p];
      L[i * ld + j] = s / L[j * ld + j];
    }
    __syncwarp();
  }
}

// Column c of (K | d) from the shared factor L, solved in place in K or d.
template <typename T>
__device__ __forceinline__ void solve_column_smem(const Space<T>& sp, int n,
                                                  int m, int c, T* dv1,
                                                  T* dv2) {
  const int ld = sp.ld;
  const T *L = sp.factor(), *Quu = sp.Quu(), *Qu = sp.Qu();
  const T* rhs = c < n ? sp.Qux() + c : Qu;
  T* col = c < n ? sp.K() + c : sp.d();
  T* prod = c < n ? sp.QuuK() + c : sp.Quud();
  const int cs = c < n ? ld : 1;
  for (int i = 0; i < m; ++i) {
    T s = -rhs[i * cs];
    for (int p = 0; p < i; ++p) s -= L[i * ld + p] * col[p * cs];
    col[i * cs] = s / L[i * ld + i];
  }
  for (int i = m - 1; i >= 0; --i) {
    T s = col[i * cs];
    for (int p = i + 1; p < m; ++p) s -= L[p * ld + i] * col[p * cs];
    col[i * cs] = s / L[i * ld + i];
  }
  T s1 = T(0), s2 = T(0);
  for (int i = 0; i < m; ++i) {
    T acc = T(0);
    for (int p = 0; p < m; ++p) acc += Quu[i * ld + p] * col[p * cs];
    prod[i * cs] = acc;
    s1 += col[i * cs] * Qu[i];
    s2 += col[i * cs] * acc;
  }
  if (c == n) {
    *dv1 += s1;
    *dv2 += T(0.5) * s2;
  }
}

// MM > 0: the shuffle factorization with rows of MM registers (m <= MM);
// MM = 0: the generic width.
template <typename T, int TG, int MM>
__global__ void __launch_bounds__(kBlockThreads, 2) riccati_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, int per_lane,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ reg,
    T* __restrict__ Kout, T* __restrict__ dout, T* __restrict__ dV1out,
    T* __restrict__ dV2out, int Bt, int N, int n, int m) {
  // owned tiles per thread: those of Qxx and Qx at n = 16 in a group of 64,
  // at n = 32 in a group of 128
  constexpr int kNb = (TG == 64 ? kSmallDim : altro::kNarrowDim) / 4;
  constexpr int kOwn = (2 * kNb * (kNb + 1) + kNb + TG - 1) / TG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int gpb = blockDim.x / TG;
  const int grp = threadIdx.x / TG;
  const int t = threadIdx.x % TG;
  const int bar = 1 + grp;
  const int b_raw = blockIdx.x * gpb + grp;
  const bool active = b_raw < Bt;
  const int b = active ? b_raw : Bt - 1;  // a spare group mirrors the last
  const int N1 = N - 1;

  // shared memory: the block's two buffers of shared dynamics, the groups'
  // spaces (two staging buffers, then the work space), the block's tables
  const int ld = row_stride(n, m), slot = slot_elems(n, m);
  const int blk = per_lane ? 0 : kDynSlots * slot;
  const int stage_elems = (kStageSlots + (per_lane ? kDynSlots : 0)) * slot;
  T* gbuf = smem + 2 * blk + grp * group_slots(per_lane) * slot;
  Space<T> sp;
  sp.w = gbuf + 2 * stage_elems;
  sp.ld = ld;
  sp.slot = slot;

  // the tables: where each staged element goes, and the tiles of passes 1
  // and 2
  const int n_src = source_elems(n, m);
  const int n_p1 = pass1_tiles(n, m);
  const int n_own = owned_tiles(n);
  const int n_p2 = pass2_tiles(n, m);
  int* stg = reinterpret_cast<int*>(
      smem + 2 * blk + gpb * group_slots(per_lane) * slot);
  const int* tiles1 = stg + n_src;
  const int* tiles2 = tiles1 + n_p1;
  // every slot starts at zero, and nothing but zeros ever reaches a slot's
  // padding (a product with a zero operand, a copy of zeros)
  for (int e = threadIdx.x;
       e < 2 * blk + gpb * group_slots(per_lane) * slot; e += blockDim.x)
    smem[e] = T(0);
  for (int e = threadIdx.x; e < n_src + n_p1 + n_p2; e += blockDim.x) {
    if (e < n_src)
      stg[e] = staged_offset(e, n, m, per_lane);
    else if (e < n_src + n_p1)
      stg[e] = pass1_code(e - n_src, n, m);
    else
      stg[e] = pass2_code(e - n_src - n_p1, n, m);
  }
  __syncthreads();

  // knot k's rows into buffer k & 1: the group's own, and the block's
  // shared dynamics
  auto stage = [&](int k) {
    const bool term = k == N1;
    T* dst = gbuf + (k & 1) * stage_elems;
    const int* tab = stg;
    const size_t kn = (size_t)b * N + k;
    auto rows = [&](const T* src, int count) {
#pragma unroll 1
      for (int e = t; e < count; e += TG)
        altro::cp_async(dst + tab[e], src + e);
      tab += count;
    };
    rows(lx + kn * n, n);
    rows(lxx + kn * n * n, n * n);
    if (term) return;  // the terminal knot has no control and no dynamics
    rows(lu + kn * m, m);
    rows(luu + kn * m * m, m * m);
    rows(lux + kn * m * n, m * n);
    if (per_lane) {
      rows(A + ((size_t)b * N1 + k) * n * n, n * n);
      rows(Bm + ((size_t)b * N1 + k) * n * m, n * m);
    } else {
      T* sd = smem + (k & 1) * blk;
#pragma unroll 1
      for (int e = threadIdx.x; e < n * n + n * m; e += blockDim.x)
        altro::cp_async(sd + tab[e], e < n * n ? A + (size_t)k * n * n + e
                                               : Bm + (size_t)k * n * m +
                                                     (e - n * n));
    }
  };

  // the thread's owned tiles of Qxx and Qx: tiles t + s TG (s < kOwn) of
  // pass 2, kept in registers from pass 2 to pass 4
  T own_q[kOwn][4];
#pragma unroll
  for (int s = 0; s < kOwn; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) own_q[s][q] = T(0);
  }
  const T regb = reg[b];
  T dv1 = T(0), dv2 = T(0);

  stage(N1);
  altro::cp_async_commit();
  for (int k = N1; k >= 0; --k) {
    // knot k has landed, and the group (with shared dynamics: the block) is
    // past knot k+1, whose buffer the prefetch of knot k-1 now takes
    altro::cp_async_wait_all();
    if (per_lane)
      altro::group_sync(bar, TG);
    else
      __syncthreads();
    if (k > 0) {
      stage(k - 1);
      altro::cp_async_commit();
    }
    sp.st = gbuf + (k & 1) * stage_elems;
    sp.dyn = per_lane ? sp.st + kStageSlots * slot : smem + (k & 1) * blk;

    if (k == N1) {
      // V is the terminal expansion; the next knot's barrier shows it
#pragma unroll 1
      for (int e = t; e < ld + n * ld; e += TG) {
        if (e < ld)
          sp.Vx()[e] = sp.lx()[e];
        else
          sp.Vxx()[e - ld] = sp.lxx()[e - ld];
      }
      continue;
    }

    // pass 1: the tiles of V A [n, n] and V B [n, m], one loop body, the
    // operand by pointer
#pragma unroll 1
    for (int e = t; e < n_p1; e += TG) {
      const int code = tiles1[e];
      const bool vb = code >> 16;
      const int i = code & 255, j = 4 * ((code >> 8) & 255);
      const T* D = (vb ? sp.B() : sp.A()) + j;
      const T* Vi = sp.Vxx() + i * ld;
      T acc[4] = {T(0), T(0), T(0), T(0)}, t4[4];
#pragma unroll 4
      for (int p = 0; p < n; ++p) {
        const T x = Vi[p];
        load4(D + p * ld, t4);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += x * t4[q];
      }
      store4((vb ? sp.VB() : sp.VA()) + i * ld + j, acc);
    }
    altro::group_sync(bar, TG);

    // pass 2: every Q tile at once; slot s of thread t is tile t + s TG,
    // and the owned ones stay in own_q[s]
#pragma unroll 1
    for (int s = 0; t + s * TG < n_p2; ++s) {
      const int e = t + s * TG;
      T v[4];
      q_tile(sp, n, m, tiles2[e], v);
      if (e < n_own) {
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          if (o == s) {
#pragma unroll
            for (int q = 0; q < 4; ++q) own_q[o][q] = v[q];
          }
        }
      }
    }
    altro::group_sync(bar, TG);

    // pass 3: (K | d), Quu K, Quu d, dV
    if constexpr (MM > 0) {
      // the factor's MM + n + 1 <= 32 rows and the n + 1 back substitutions
      // all sit in the first warp
      if (t < 32) {
        factor_forward<T, MM>(sp, regb, n, m, t);
        __syncwarp();
        if (t <= n) solve_back<T, MM>(sp, n, t, &dv1, &dv2);
      }
    } else {
      factor_warp(sp, regb, m, t);
      altro::group_sync(bar, TG);
      if (t <= n) solve_column_smem(sp, n, m, t, &dv1, &dv2);
    }
    altro::group_sync(bar, TG);

    // pass 4: V from the owned Q tiles; K and d stored coalesced
    const T *Km = sp.K(), *Qux = sp.Qux();
#pragma unroll 1
    for (int s = 0; s < kOwn && t + s * TG < n_own; ++s) {
      const int code = tiles2[t + s * TG];
      const int i = code & 255, j = 4 * ((code >> 8) & 255);
      T q4[4], s1[4], s2[4], s3[4], a4[4], b4[4], c4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        q4[q] = s1[q] = s2[q] = s3[q] = T(0);
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          if (o == s) q4[q] = own_q[o][q];
        }
      }
      if (code >> 16 == 0) {
        // Vxx = Qxx + K'Quu K + K'Qux + Qux'K, upper triangle mirrored
        const T* QuuK = sp.QuuK();
#pragma unroll 2
        for (int p = 0; p < m; ++p) {
          const T ki = Km[p * ld + i], qi = Qux[p * ld + i];
          load4(QuuK + p * ld + j, a4);
          load4(Qux + p * ld + j, b4);
          load4(Km + p * ld + j, c4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            s1[q] += ki * a4[q];
            s2[q] += ki * b4[q];
            s3[q] += c4[q] * qi;
          }
        }
        T* Vxx = sp.Vxx();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = j + q;
          const T v = q4[q] + s1[q] + s2[q] + s3[q];
          if (c >= i && c < n) Vxx[i * ld + c] = Vxx[c * ld + i] = v;
        }
      } else {
        // Vx = Qx + K'(Quu d + Qu) + Qux' d
        const T *Quud = sp.Quud(), *Qu = sp.Qu(), *dk = sp.d();
#pragma unroll 2
        for (int p = 0; p < m; ++p) {
          const T g = Quud[p] + Qu[p], dp = dk[p];
          load4(Km + p * ld + j, a4);
          load4(Qux + p * ld + j, b4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            s1[q] += a4[q] * g;
            s2[q] += b4[q] * dp;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) q4[q] = q4[q] + s1[q] + s2[q];
        store4(sp.Vx() + j, q4);
      }
    }
    if (active) {
      T* Kb = Kout + ((size_t)b * N1 + k) * m * n;
      T* db = dout + ((size_t)b * N1 + k) * m;
      const T* dk = sp.d();
#pragma unroll 1
      for (int e = t; e < m * n + m; e += TG) {
        if (e < m * n)
          Kb[e] = Km[e / n * ld + e % n];
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
int launch_group(const void* A, const void* Bm, int per_lane, const void* lx,
                 const void* lu, const void* lxx, const void* luu,
                 const void* lux, const void* reg, void* K, void* d,
                 void* dV1, void* dV2, int Bt, int N, int n, int m,
                 cudaStream_t stream) {
  const size_t cap = 232448;  // 227 KB opt-in limit
  const size_t tables =
      (size_t)(source_elems(n, m) + pass1_tiles(n, m) + pass2_tiles(n, m)) *
      sizeof(int);
  const size_t slot = (size_t)slot_elems(n, m) * sizeof(T);
  // groups per block: 256 threads, halved until the spaces fit
  int gpb = kBlockThreads / TG;
  size_t bytes = 0;
  for (;;) {
    bytes = ((per_lane ? 0 : 2 * kDynSlots) + gpb * group_slots(per_lane)) *
                slot +
            tables;
    if (bytes <= cap || gpb == 1) break;
    gpb /= 2;
  }
  if (bytes > cap) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        riccati_kernel<T, TG, MM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((Bt + gpb - 1) / gpb);
  riccati_kernel<T, TG, MM><<<blocks, gpb * TG, bytes, stream>>>(
      (const T*)A, (const T*)Bm, per_lane, (const T*)lx, (const T*)lu,
      (const T*)lxx, (const T*)luu, (const T*)lux, (const T*)reg, (T*)K,
      (T*)d, (T*)dV1, (T*)dV2, Bt, N, n, m);
  return (int)cudaGetLastError();
}

// The wide body, for n or m above kNarrowDim (up to kMaxDim); it replaces
// the TPU kernel altro_tpu/ops/riccati.py: batched_riccati at those
// widths. It is kernel B's tiled wide body (riccati_fused.cu:
// fused_expand_backward_wide) with the expansion read instead of formed,
// and it is faster than the entry-per-thread body (wide_entry.cuh's tail)
// that it replaced, at every wide shape measured, n = 35, m = 2 included
// (PERF.md).
// One block works one scenario: 128 threads at a narrow control (the
// state_dim sweep's n <= 55 with m = 2: four scenarios per SM), 512 at
// n = m = 64. Per knot, over the concatenated width W = n + m with
// F = [A | B] (the shared rows or the scenario's):
//
//   G = Vxx F                                       [n x W]
//   Qfull = F'G + [lxx lux'; lux luu]  (upper triangle) [W x W]
//
// as block-wide products of 4 x 4 register tiles, each tile's sums seeded
// with its expansion entries (lxx's upper triangle, lux, luu's lower
// triangle); F'Vx + (lx | lu) rides along as one extra column (Qx, Qu).
// The expansion is written straight into the Riccati tail's layout, whose
// blocked factor, solves, Quu K and V are wide.cuh's (pivots clamped as
// sqrt(max(., 1e-12)), a NaN kept).
//
// The knot's F comes into padded shared rows by cp.async (16-byte copies
// when n and m allow), issued once the knot's products have read the last
// knot's, so that it lands during the tail; where that stage does not fit
// beside the tail (float64 at n = 64, m >= 63), F lies behind G in the
// region and is issued once the tail is done with it. The expansion rows are
// read once, from device memory, straight into the tiles' sums (lxx's
// upper triangle, lux, luu's lower triangle): staging them too, one knot
// ahead, measured slower at every wide shape (PERF.md), for their
// element-wise copies and the stage's shared memory (fewer blocks to an
// SM).
//
// What bounds it on the H100: at n = m = 64, N = 21, B = 1024 its FLOPs
// (~86 GFLOP with Qxx's and Quu's upper triangles, 1.28 ms at 67 TFLOP/s
// in float32) against ~1.4 GB of bytes (0.42 ms). It reaches 14.1 ms there
// (PERF.md; H100 80GB HBM3, 700 W), set, as in B's body, by
// the tail's barriers (38 per knot at m = 64) and the products'
// shared-memory reads, one scenario's knot chain per block; at m = 2, by
// a knot's chain of eight barriers.
constexpr int kSmallThreads = 128;
constexpr int kLargeThreads = 512;

// Offsets (in elements) of the tiled body's shared memory: Qx, Vx, Qu,
// qdiag, inv; then, 16-byte aligned, Vq, Qux, the region (G, then aug and
// Quu K) and F's stage [n x Wp]; with `behind`, F lies in the region
// behind G instead.
struct DLayout {
  int Qx, Vx, Qu, qdiag, inv, Vq, Qux, region, F, total;
  __host__ __device__ DLayout(int n, int m, bool behind) {
    using altro::wide::pad4;
    const altro::wide::TailDims td(n, m);
    const int g = n * pad4(n + m), tail = m * (td.lda + td.ldk);
    Qx = 0;
    Vx = Qx + n;
    Qu = Vx + n;
    qdiag = Qu + m;
    inv = qdiag + m;
    Vq = pad4(inv + m);
    Qux = Vq + n * td.ldn;
    region = Qux + m * td.ldn;
    const int used = behind ? 2 * g : g;
    const int rg = pad4(used > tail ? used : tail);
    F = behind ? region + g : region + rg;
    total = region + rg + (behind ? 0 : g);
  }
};

// A knot's expansion rows in device memory: lxx [n x n] (its upper
// triangle read), lux [m x n], luu [m x m] (its lower triangle read), lx,
// lu.
template <typename T>
struct Seeds {
  const T *lxx, *lux, *luu, *lx, *lu;
};

// G = Vxx F [n x Wp] (Vxx symmetric: row p of Vq is its column p), up to
// KT 4 x 4 tiles per thread.
template <typename T, int KT>
__device__ __noinline__ void gain_product(const T* Vq, int ldn, const T* F,
                                          int Wp, T* G, int n) {
  namespace wd = altro::wide;
  const int W4 = Wp / 4, t = threadIdx.x, nt = blockDim.x;
  const int tiles = (n + 3) / 4 * W4;
  T acc[KT][4][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    wd::zero4(acc[s]);
    const int q = t + s * nt;
    if (q >= tiles) break;
    const int i0 = q / W4 * 4, j0 = q % W4 * 4;
#pragma unroll 4
    for (int p = 0; p < n; ++p) {
      T av[4], bv[4];
      wd::ld4(Vq + p * ldn + i0, av);
      wd::ld4(F + p * Wp + j0, bv);
      wd::outer4(acc[s], av, bv);
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

// Qfull = F'G + the expansion over the upper triangle of [W x W] (at the
// terminal knot the expansion's x block alone), up to KT 4 x 4 tiles per
// thread, and the extra column F'Vx + (lx | lu) on the first W threads;
// then, once G is read no more, the expansion in the tail's layout: Qxx
// (upper) in Vq, Qux and -Qux into aug's right-hand sides, Quu + reg I
// (upper) and Quu (strict lower, diagonal in qdiag) into aug, Qx and Qu.
// Ends on a barrier.
template <typename T, int KT>
__device__ __noinline__ void expansion(const altro::wide::Tail<T> tl,
                                       const T* F, const T* G, int Wp,
                                       const Seeds<T> sd, bool term, T regb) {
  namespace wd = altro::wide;
  const int n = tl.n, m = tl.m, W4 = Wp / 4, W = n + m, Wo = term ? n : W;
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
    act[s] = act[s] && (!term || j2[s] < n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i2[s] + r, j = j2[s] + c;
        const bool in = act[s] && i <= j && j < Wo;
        const int kind = j < n ? 0 : i < n ? 1 : 2;  // Qxx, Qxu, Quu
        const T* src = kind == 0   ? sd.lxx + i * n + j
                       : kind == 1 ? sd.lux + (j - n) * n + i
                                   : sd.luu + (j - n) * m + (i - n);
        acc[s][r][c] = in ? *src : T(0);
      }
  }
  T gv = T(0);
  if (!term) {
    if (t < W)
      for (int p = 0; p < n; ++p) gv += F[p * Wp + t] * tl.Vx[p];
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      if (!act[s]) continue;
#pragma unroll 2
      for (int p = 0; p < n; ++p) {
        T av[4], bv[4];
        wd::ld4(F + p * Wp + i2[s], av);
        wd::ld4(G + p * Wp + j2[s], bv);
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
            tl.aug[a * lda + a] = v + regb;
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
    const T v = (t < n ? sd.lx[t] : sd.lu[t - n]) + gv;
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
riccati_wide(const T* __restrict__ A, const T* __restrict__ Bm, int per_lane,
             const T* __restrict__ lx, const T* __restrict__ lu,
             const T* __restrict__ lxx, const T* __restrict__ luu,
             const T* __restrict__ lux, const T* __restrict__ reg,
             T* __restrict__ Kout, T* __restrict__ dout,
             T* __restrict__ dV1out, T* __restrict__ dV2out, int N, int n,
             int m, int vec, int behind) {
  namespace wd = altro::wide;
  // 4 x 4 tiles per thread: G has at most 16 x 32 = 512 (the small blocks:
  // 256), Qfull's upper triangle at most 32 x 33 / 2 = 528 (128)
  constexpr int kT1 = NT == kSmallThreads ? 2 : 1;
  constexpr int kT2 = NT == kSmallThreads ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, N1 = N - 1;
  const DLayout lo(n, m, behind);
  const wd::TailDims td(n, m);
  const int Wp = wd::pad4(n + m);
  T* G = smem + lo.region;
  const wd::Tail<T> tl{smem + lo.Vq, smem + lo.Qx, smem + lo.Vx,
                       smem + lo.Qux, smem + lo.Qu, G, smem + lo.qdiag,
                       smem + lo.inv, G + m * td.lda, n, m, td.ldn, td.ldk,
                       td.ma, td.lda};
  const int v = vec ? 16 / (int)sizeof(T) : 1;
  const altro::Spread spn(n / v, t, nt), spm(m / v, t, nt);

  T* F = smem + lo.F;
  // knot k's F (below the terminal knot)
  auto stage = [&](int k) {
    const size_t kd = per_lane ? (size_t)b * N1 + k : (size_t)k;
    altro::stage_rows(F, Wp, A + kd * n * n, n, n, vec, spn);
    altro::stage_rows(F + n, Wp, Bm + kd * n * m, n, m, vec, spm);
    altro::cp_async_commit();
  };

  const T regb = reg[b];
  T dv1 = T(0), dv2 = T(0);
  for (int k = N1; k >= 0; --k) {
    const bool term = k == N1;
    // knot k's F has landed, and every thread is past knot k+1
    altro::cp_async_wait_all();
    __syncthreads();
    const size_t kn = (size_t)b * N + k;
    const Seeds<T> sd{lxx + kn * n * n, lux + kn * m * n, luu + kn * m * m,
                      lx + kn * n, lu + kn * m};
    if (!term) {
      gain_product<T, kT1>(tl.Vq, td.ldn, F, Wp, G, n);
      __syncthreads();  // G whole before the expansion reads it
    }
    expansion<T, kT2>(tl, F, G, Wp, sd, term, regb);
    // F is read no more: the next knot's lands during the tail
    if (!behind && k > 0) stage(k - 1);

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
    // F behind G: the next knot's lands once the tail is done
    if (behind && k > 0) stage(k - 1);
  }
  if (t == 0) {
    dV1out[b] = dv1;
    dV2out[b] = dv2;
  }
}

template <typename T, int NT>
int launch_wide_nt(const void* A, const void* Bm, int per_lane,
                   const void* lx, const void* lu, const void* lxx,
                   const void* luu, const void* lux, const void* reg,
                   void* K, void* d, void* dV1, void* dV2, int Bt, int N,
                   int n, int m, cudaStream_t stream) {
  auto kern = riccati_wide<T, NT>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  // F's own stage where it fits beside the tail, else F behind G
  int behind = 0;
  size_t bytes = (size_t)DLayout(n, m, false).total * sizeof(T);
  if (bytes > 232448 - attr.sharedSizeBytes) {
    behind = 1;
    bytes = (size_t)DLayout(n, m, true).total * sizeof(T);
  }
  e = altro::wide::prepare(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies of the staged rows when every row starts aligned
  const int v = 16 / (int)sizeof(T);
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = n % v == 0 && m % v == 0 && aligned(A) && aligned(Bm);
  kern<<<Bt, NT, bytes, stream>>>(
      (const T*)A, (const T*)Bm, per_lane, (const T*)lx, (const T*)lu,
      (const T*)lxx, (const T*)luu, (const T*)lux, (const T*)reg, (T*)K,
      (T*)d, (T*)dV1, (T*)dV2, N, n, m, vec, behind);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* A, const void* Bm, int per_lane, const void* lx,
                const void* lu, const void* lxx, const void* luu,
                const void* lux, const void* reg, void* K, void* d,
                void* dV1, void* dV2, int Bt, int N, int n, int m,
                cudaStream_t stream) {
  const int W4 = altro::wide::pad4(n + m) / 4;
  const bool small = (n + 3) / 4 * W4 <= 2 * kSmallThreads &&
                     W4 * (W4 + 1) / 2 <= kSmallThreads;
  auto launch = small ? launch_wide_nt<T, kSmallThreads>
                      : launch_wide_nt<T, kLargeThreads>;
  return launch(A, Bm, per_lane, lx, lu, lxx, luu, lux, reg, K, d, dV1, dV2,
                Bt, N, n, m, stream);
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
  cudaStream_t s = (cudaStream_t)stream;
  if (n > altro::kNarrowDim || m > altro::kNarrowDim)
    return launch_wide<T>(A, Bm, per_lane, lx, lu, lxx, luu, lux, reg, K, d,
                          dV1, dV2, Bt, N, n, m, s);
#define ALTRO_RICCATI_LAUNCH(TG, MM)                                        \
  launch_group<T, TG, MM>(A, Bm, per_lane, lx, lu, lxx, luu, lux, reg, K,   \
                          d, dV1, dV2, Bt, N, n, m, s)
  // 64 threads per scenario up to n, m = 16 while the factor's rows (m
  // rounded up to MM = 4, 8, 12 or 16, and n + 1 right-hand sides) fit a
  // warp; 128 threads and the generic width above
  if (n > kSmallDim || m > kSmallDim || ((m + 3) & ~3) + n + 1 > 32)
    return ALTRO_RICCATI_LAUNCH(128, 0);
  if (m <= 4) return ALTRO_RICCATI_LAUNCH(64, 4);
  if (m <= 8) return ALTRO_RICCATI_LAUNCH(64, 8);
  if (m <= 12) return ALTRO_RICCATI_LAUNCH(64, 12);
  return ALTRO_RICCATI_LAUNCH(64, 16);
#undef ALTRO_RICCATI_LAUNCH
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
