// Shared helpers of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() right after the launch.
#pragma once

#include <cuda_runtime.h>

namespace altro {

// Size limits shared by every kernel and checked by the Python wrappers:
// state and control widths up to kMaxDim, constraint rows up to kMaxRows
// (one bit each in the per-row cone mask), ladders up to kMaxRungs.
constexpr int kMaxDim = 32;
constexpr int kMaxRows = 64;
constexpr int kMaxRungs = 32;

}  // namespace altro
