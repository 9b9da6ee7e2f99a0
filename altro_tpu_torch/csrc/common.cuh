// Shared helpers of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() right after the launch.
#pragma once

#include <cuda_runtime.h>

namespace altro {

// Size limits shared by every kernel and checked by the Python wrappers:
// state and control widths up to kMaxDim, constraint rows up to kMaxRows in
// at most kMaxBlocks blocks, ladders up to kMaxRungs. Widths up to
// kNarrowDim take each kernel's group body (a group of threads per
// scenario, rows in registers and shuffles); wider ones take its wide body
// (a block per scenario or per (scenario, rung), wide.cuh).
constexpr int kMaxDim = 64;
constexpr int kNarrowDim = 32;
constexpr int kMaxRows = 64;
constexpr int kMaxBlocks = 16;
constexpr int kMaxRungs = 32;

// Cone codes of the block table (ops/blocks.py: CONE_CODES).
constexpr int kZero = 0;
constexpr int kNonpos = 1;
constexpr int kSoc = 2;

// The constraint blocks of a problem, passed by value as a kernel parameter:
// block i owns rows row0[i] .. row0[i] + p[i] - 1 of the row-concatenated
// stacks, and its per-lane multipliers lam[i] are [Bt, N, p[i]]. SOC blocks
// are numbered 0 .. nsoc-1 in block order (slot[i], -1 for other cones;
// soc_block[s] is the block of SOC slot s).
template <typename T>
struct BlockTable {
  int count;
  int nsoc;
  int row0[kMaxBlocks];
  int p[kMaxBlocks];
  int cone[kMaxBlocks];
  int slot[kMaxBlocks];
  int soc_block[kMaxBlocks];
  const T* lam[kMaxBlocks];
};

// Fill a table from the entry point's arguments: meta holds (row0, p, cone)
// per block. Returns false on a malformed table.
template <typename T>
inline bool make_table(int nblocks, const int* meta, const void* const* lams,
                       int P, BlockTable<T>* tab) {
  if (nblocks < 0 || nblocks > kMaxBlocks) return false;
  tab->count = nblocks;
  tab->nsoc = 0;
  int row = 0;
  for (int i = 0; i < kMaxBlocks; ++i) {
    tab->row0[i] = tab->p[i] = tab->cone[i] = 0;
    tab->slot[i] = tab->soc_block[i] = -1;
    tab->lam[i] = nullptr;
  }
  for (int i = 0; i < nblocks; ++i) {
    const int row0 = meta[3 * i], p = meta[3 * i + 1], cone = meta[3 * i + 2];
    if (row0 != row || p < 1 || cone < kZero || cone > kSoc) return false;
    if (cone == kSoc && p < 2) return false;
    tab->row0[i] = row0;
    tab->p[i] = p;
    tab->cone[i] = cone;
    tab->lam[i] = static_cast<const T*>(lams[i]);
    if (cone == kSoc) {
      tab->slot[i] = tab->nsoc;
      tab->soc_block[tab->nsoc++] = i;
    }
    row += p;
  }
  return row == P;
}

// The block that owns row rr.
template <typename T>
__device__ inline int block_of(const BlockTable<T>& tab, int rr) {
  int bi = 0;
  while (bi + 1 < tab.count && rr >= tab.row0[bi + 1]) ++bi;
  return bi;
}

}  // namespace altro
