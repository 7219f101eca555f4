// K1: FM score and VBFM T-term forward over the padded row layout.
//
// Replaces svbfm_tpu/ops/forward.py:fm_scores and :fm_t_terms (XLA gather
// chains).  Per row n of ids/vals [N, P]:
//   score = w0 + sum_p w x + 1/2 sum_f [(sum_p v x)^2 - sum_p (v x)^2]
//   T     = s0 + sum_p sw x^2
//           + sum_f [1/2 z^2 + z q2 - sum_p (m^2 x^4 s + 1/2 x^4 s^2)]
//   with q2 = sum_p (m x)^2, z = sum_p s x^2.
//
// Layout: the parameter tables arrive channel-stacked and row-major,
// [D, 1+K] (w, v) or [D, 1+2K] (sw, m, s), so one row position reads one
// contiguous run of floats.  One warp per row, lanes over factors, a warp
// shuffle for the factor sum.
//
// Bound: memory.  Each row reads P ids, P values and P table rows of
// (1+K) or (1+2K) floats in random order (the table, 0.8-1.6 MB at the
// ML-1M shape, stays in L2); the arithmetic is a few FLOPs per float read.
// The TPU version's per-position flat gathers, which dodged the TPU's
// (8,128) tile padding and its per-index gather cost, are not carried over.
#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fm_scores_kernel(const float* __restrict__ tab, int K,
                                 const float* __restrict__ w0,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ vals, int64_t N,
                                 int P, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const int64_t ld = K + 1;
  const int* rid = ids + n * P;
  const float* rx = vals + n * P;
  float part = 0.f;
  for (int f = lane; f < K; f += 32) {
    float s = 0.f, s2 = 0.f;
    for (int p = 0; p < P; ++p) {
      const float d = tab[rid[p] * ld + 1 + f] * rx[p];
      s += d;
      s2 += d * d;
    }
    part += 0.5f * (s * s - s2);
  }
  part = svbfm::warp_sum(part);
  if (lane == 0) {
    float acc = *w0;
    for (int p = 0; p < P; ++p) acc += tab[rid[p] * ld] * rx[p];
    out[n] = acc + part;
  }
}

__global__ void fm_t_terms_kernel(const float* __restrict__ tab, int K,
                                  const float* __restrict__ s0,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ vals, int64_t N,
                                  int P, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const int64_t ld = 1 + 2 * K;
  const int* rid = ids + n * P;
  const float* rx = vals + n * P;
  float part = 0.f;
  for (int f = lane; f < K; f += 32) {
    float q2 = 0.f, z = 0.f, neg = 0.f;
    for (int p = 0; p < P; ++p) {
      const float* g = tab + rid[p] * ld;
      const float x = rx[p];
      const float x2 = x * x;
      const float m = g[1 + f];
      const float s = g[1 + K + f];
      const float mx = m * x;
      q2 += mx * mx;
      z += s * x2;
      neg += m * m * (x2 * x2) * s + 0.5f * (x2 * x2) * s * s;
    }
    part += 0.5f * z * z + z * q2 - neg;
  }
  part = svbfm::warp_sum(part);
  if (lane == 0) {
    float acc = *s0;
    for (int p = 0; p < P; ++p) {
      const float x = rx[p];
      acc += tab[rid[p] * ld] * (x * x);
    }
    out[n] = acc + part;
  }
}

inline unsigned row_blocks(int64_t N) {
  return static_cast<unsigned>((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// tab [D, 1+K] = (w | v^T); w0 a device scalar; out [N]
SVBFM_EXPORT int svbfm_fm_scores(const float* tab, int K, const float* w0,
                                 const int* ids, const float* vals, int64_t N,
                                 int P, float* out, cudaStream_t stream) {
  fm_scores_kernel<<<row_blocks(N), 32 * kWarpsPerBlock, 0, stream>>>(
      tab, K, w0, ids, vals, N, P, out);
  return static_cast<int>(cudaGetLastError());
}

// tab [D, 1+2K] = (sw | m^T | s^T); s0 a device scalar; out [N]
SVBFM_EXPORT int svbfm_fm_t_terms(const float* tab, int K, const float* s0,
                                  const int* ids, const float* vals, int64_t N,
                                  int P, float* out, cudaStream_t stream) {
  fm_t_terms_kernel<<<row_blocks(N), 32 * kWarpsPerBlock, 0, stream>>>(
      tab, K, s0, ids, vals, N, P, out);
  return static_cast<int>(cudaGetLastError());
}
