// Helpers shared by the svbfm_tpu_torch CUDA sources.
//
// Every library exports plain C launch functions that take raw device
// pointers and a cudaStream_t, launch on that stream, never synchronise,
// allocate nothing, and return cudaGetLastError() so that a refused launch
// (bad configuration) is reported to the Python wrapper at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SVBFM_EXPORT extern "C" __attribute__((visibility("default")))

namespace svbfm {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Sum over the kLanes threads that share one row: a warp (32), or one
// thread (1), where the sum is the value itself.
template <int kLanes>
__device__ __forceinline__ float row_sum(float v) {
  static_assert(kLanes == 1 || kLanes == 32, "a thread or a warp per row");
  return kLanes == 1 ? v : warp_sum(v);
}

}  // namespace svbfm

SVBFM_EXPORT const char* svbfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
