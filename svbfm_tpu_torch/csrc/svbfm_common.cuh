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

// The padding rule of the column and relation-row sums (X8a at F = 1,
// X10a): a degree bucket's padding slots have x = 0 and point at one pad
// row, and the JAX code adds x times the gathered values at every slot, so
// a non-finite e or q at the pad row makes a padded column's sums NaN.  A
// slot with x = 0 at the row of the column's last slot, where that slot is
// padding too, adds what the last slot adds: it gathers nothing.  The last
// slot and every other slot are gathered and added, so the sums keep the
// NaN/Inf pattern of the plain sum over all slots.
struct PadRow {
  int r_last, L;
  bool pad;
  __device__ PadRow(const int* crow, const float* cx, int len)
      : r_last(len > 0 ? crow[len - 1] : 0), L(len),
        pad(len > 0 && cx[len - 1] == 0.f) {}
  // from the last slot's row id and whether its x is 0, read before
  __device__ PadRow(int last_row, int len, bool last_pad)
      : r_last(last_row), L(len), pad(last_pad) {}
  // whether slot l (row r, value xv) is gathered and added
  __device__ bool gathers(int l, int r, float xv) const {
    return xv != 0.f || l == L - 1 || !pad || r != r_last;
  }
};

}  // namespace svbfm

SVBFM_EXPORT const char* svbfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
