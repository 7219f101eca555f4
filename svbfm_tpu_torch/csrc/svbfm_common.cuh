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

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// The 8- and 16-byte vector types of float and int.
template <typename T, int W>
struct VecOf;
template <>
struct VecOf<float, 4> { using type = float4; };
template <>
struct VecOf<float, 2> { using type = float2; };
template <>
struct VecOf<int, 4> { using type = int4; };
template <>
struct VecOf<int, 2> { using type = int2; };

// V consecutive floats or ints at p, read as V / W loads of W (W = 4, 2,
// 1: 16-, 8- or 4-byte loads; p aligned to 4 W bytes).
template <int V, int W = V, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  static_assert(V % W == 0, "a whole number of loads");
#pragma unroll
  for (int i = 0; i < V; i += W) {
    if constexpr (W == 4) {
      const auto a = *reinterpret_cast<const typename VecOf<T, 4>::type*>(
          p + i);
      v[i] = a.x, v[i + 1] = a.y, v[i + 2] = a.z, v[i + 3] = a.w;
    } else if constexpr (W == 2) {
      const auto a = *reinterpret_cast<const typename VecOf<T, 2>::type*>(
          p + i);
      v[i] = a.x, v[i + 1] = a.y;
    } else {
      v[i] = p[i];
    }
  }
}

// V consecutive floats to p in one store (p aligned to 4 V bytes).
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Whether p is a multiple of ``bytes`` (nullptr is).
inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest chunk (4, 2 or 1 floats) that divides F and at which every
// pointer given is aligned.
template <typename... Ptrs>
int chunk_width(int F, Ptrs... ptrs) {
  int v = F % 4 == 0 ? 4 : F % 2 == 0 ? 2 : 1;
  while (v > 1 && !(aligned(ptrs, 4u * v) && ...)) v /= 2;
  return v;
}

// Columns a block of a form with U lanes a column (a power of two <= 32)
// on a bucket of C columns, blocks of at most `most` threads: about
// kSpreadBlocks blocks (the H100 has 132 SMs), so that a small bucket's
// gathers spread over the SMs, but at least 64 threads (whole warps: the
// forms shuffle over all 32 lanes).  Mirrored by kernels/mcmc_sweep.py:
// lanes_block_cols.
constexpr int kSpreadBlocks = 128;

inline int lanes_block_cols(int C, int U, int most) {
  const int cpb = ceil_div(C, kSpreadBlocks);
  return cpb < 64 / U ? 64 / U : cpb > most / U ? most / U : cpb;
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
