// FMA-issue calibration: the rate at which the card issues the multiply-adds
// that the solver kernels are made of, in the launch regime they run in.
//
// Replaces the TPU probe tools/exp_r5_roofline.py: calibrate_macs (Pallas
// body at :52-61), which measured the vector-MAC issue ceiling that the
// reference's kernels were rated against. Work item (g, lane), for every
// grid step g < grid and every lane < lanes (the elements of a and x):
//
//   acc_i = a[lane] * (1 + i)                       i = 0 .. S-1
//   inner rounds of  acc_i = fma(acc_i, 0.999999, x[lane])
//   out[lane] = acc_0 + acc_1 + ... + acc_{S-1}     (in that order)
//
// Every grid step writes the same value to out, as every grid step of the
// probe writes its one output block. a and x come from device memory, so
// nothing folds at compile time; the S accumulators are independent, so the
// FMA latency (about 4 cycles for FFMA) hides behind the other streams and
// the other warps of the sub-partition, and the rate is the issue ceiling,
// not a dependency chain's.
//
// What bounds it: the operations, by design. One warp instruction issues per
// clock on each of an SM's four sub-partitions, and an FFMA of a warp takes
// one issue slot (32 lanes of the sub-partition's 32 FP32 units), so the
// card's ceiling is 132 SMs x 128 lanes x 2 FLOP a clock; DFMA runs at half
// that (64 FP64 units an SM). The bytes are a[lanes], x[lanes] read and
// out[lanes] written: nothing. The design keeps everything but FMAs off the
// issue slots of the hot loop: the rounds run in a loop unrolled kUnroll
// times (kUnroll x S FMAs against the counter's increment, compare and
// branch), with a remainder loop for inner % kUnroll rounds. The grid is
// one wave of resident blocks, the SM count times the blocks an SM holds
// (both asked of the runtime), and each thread strides over the work items;
// with grid x lanes items not a multiple of the threads, the last stride
// leaves some threads idle (at the default 4096 x 1024 items, 15.5 items a
// thread at 2048 threads an SM: up to 1/16 of the time).
#include <cuda_runtime.h>

namespace altro {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;

// one fused multiply-add, rounded once, whatever the compiler's contraction
// flags
__device__ __forceinline__ float fused(float p, float q, float r) {
  return __fmaf_rn(p, q, r);
}
__device__ __forceinline__ double fused(double p, double q, double r) {
  return __fma_rn(p, q, r);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
calibrate_fma(const T* __restrict__ a, const T* __restrict__ x,
              T* __restrict__ out, long long items, int lanes, int inner) {
  const T c = T(0.999999);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += stride) {
    const int lane = static_cast<int>(it % lanes);
    const T av = a[lane];
    const T xv = x[lane];
    T acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = av * T(1 + i);
    int r = 0;
    for (; r + kUnroll <= inner; r += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < S; ++i) acc[i] = fused(acc[i], c, xv);
      }
    }
#pragma unroll 1
    for (; r < inner; ++r) {
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] = fused(acc[i], c, xv);
    }
    T o = acc[0];
#pragma unroll
    for (int i = 1; i < S; ++i) o = o + acc[i];
    out[lane] = o;
  }
}

template <typename T, int S>
int launch(const void* a, const void* x, void* out, int grid, int lanes,
           int inner, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, calibrate_fma<T, S>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(grid) * lanes;
  const long long needed = (items + kThreads - 1) / kThreads;
  const long long wave =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(needed < wave ? needed : wave);
  calibrate_fma<T, S><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<T*>(out), items, lanes, inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_streams(const void* a, const void* x, void* out, int grid,
                   int lanes, int inner, int streams, void* stream) {
  if (grid < 1 || lanes < 1 || inner < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (streams) {
    case 1: return launch<T, 1>(a, x, out, grid, lanes, inner, stream);
    case 2: return launch<T, 2>(a, x, out, grid, lanes, inner, stream);
    case 4: return launch<T, 4>(a, x, out, grid, lanes, inner, stream);
    case 8: return launch<T, 8>(a, x, out, grid, lanes, inner, stream);
    case 16: return launch<T, 16>(a, x, out, grid, lanes, inner, stream);
    case 32: return launch<T, 32>(a, x, out, grid, lanes, inner, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace altro

extern "C" int altro_calibrate_fma_f32(const void* a, const void* x,
                                       void* out, int grid, int lanes,
                                       int inner, int streams, void* stream) {
  return altro::launch_streams<float>(a, x, out, grid, lanes, inner, streams,
                                      stream);
}

extern "C" int altro_calibrate_fma_f64(const void* a, const void* x,
                                       void* out, int grid, int lanes,
                                       int inner, int streams, void* stream) {
  return altro::launch_streams<double>(a, x, out, grid, lanes, inner,
                                       streams, stream);
}
