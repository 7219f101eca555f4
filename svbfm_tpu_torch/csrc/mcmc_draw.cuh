// The conditional draw of the Gibbs/ALS sweeps, shared by X8a
// (mcmc_sweep.cu) and X10b (bs_sweep.cu).
//
// One draw (svbfm_tpu/learners/mcmc.py:177-186, fm_learn_mcmc.h:686-712):
//   s2 = 1 / (lambda + alpha sh2),
//   new = -s2 (alpha (she - v sh2) - mu lambda) [+ sqrt(s2) z];
// a non-finite s2 gives 0, uncounted; a non-finite draw is counted and
// reverted to the old value.
//
// The exact sequential draw of a column's F factors
// (svbfm_tpu/learners/mcmc.py:exact_block_draws, :137-200) from the sums
// acc = (s0 [F] | sh2 [F] | M, the packed strict upper triangle):
//   corr = 0; for f: new_f = draw(s0_f - corr_f, sh2_f, ...);
//                    corr_g += (v_f - new_f) M_fg  (g > f).
// The recurrence is the loop JAX runs when its batched triangular solve is
// not finite; the two agree up to rounding, and the loop treats non-finite
// values the same way in every case, so no fallback is needed.
#pragma once

#include "svbfm_common.cuh"

namespace svbfm {

// One conditional draw; counts into nan_c/inf_c.
__device__ __forceinline__ float draw_one(float she, float sh2, float v_c,
                                          float mu, float lam, float alpha,
                                          bool has_z, float zv, int& nan_c,
                                          int& inf_c) {
  const float s2 = 1.f / (lam + alpha * sh2);
  const float mean = -s2 * (alpha * (she - v_c * sh2) - mu * lam);
  float val = has_z ? mean + sqrtf(s2) * zv : mean;
  if (!isfinite(s2)) val = 0.f;  // uncounted
  nan_c += isnan(val) ? 1 : 0;
  inf_c += isinf(val) ? 1 : 0;
  return isfinite(val) ? val : v_c;
}

// Offset of M_fg (f < g) in the packed strict upper triangle of F x F.
// With F + 1 and g + 1 it is the offset of (f, g), f <= g, in the packed
// upper triangle WITH the diagonal (numpy's triu_indices order).
__device__ __forceinline__ int pair_index(int f, int g, int F) {
  return f * (2 * F - f - 1) / 2 + (g - f - 1);
}

// The pair (f, g), f < g, at offset p of the packed triangle, as f << 16 | g:
// the float root of pair_index(f, f + 1, F) = p, then exact integer steps.
__device__ __forceinline__ int pair_at(int p, int F) {
  const float b = 2.f * F - 1.f;
  int f = static_cast<int>(0.5f * (b - sqrtf(b * b - 8.f * p)));
  f = max(0, min(f, F - 2));
  while (f > 0 && pair_index(f, f + 1, F) > p) --f;
  while (f < F - 2 && pair_index(f + 1, f + 2, F) <= p) ++f;
  return (f << 16) | (f + 1 + p - pair_index(f, f + 1, F));
}

// The exact sequential draw of one column's F factors by the whole block,
// in shared memory: acc = (s0 | sh2 | M packed), vc [F] the pre-bin values,
// corr [F] zeroed, prior [3, F] = (mu, lambda, z), dsh one float of
// scratch.  Thread 0 draws factor f, a barrier, the threads apply corr_g
// for g > f, a barrier.  Writes v_out[f] = new_f and dv_out[f] =
// v_f - new_f.  Every thread of the block must call it.
__device__ __forceinline__ void sequential_draws(
    const float* acc, int F, const float* vc, float* corr, const float* prior,
    float alpha, bool has_z, float* dsh, float* v_out, float* dv_out,
    int& nan_c, int& inf_c) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int f = 0; f < F; ++f) {
    if (tid == 0) {
      const float v_f = vc[f];
      const float nv = draw_one(acc[f] - corr[f], acc[F + f], v_f, prior[f],
                                prior[F + f], alpha, has_z, prior[2 * F + f],
                                nan_c, inf_c);
      v_out[f] = nv;
      dv_out[f] = v_f - nv;
      *dsh = v_f - nv;
    }
    __syncthreads();
    const float d = *dsh;
    for (int g = f + 1 + tid; g < F; g += nt)
      corr[g] += d * acc[2 * F + pair_index(f, g, F)];
    __syncthreads();
  }
}

}  // namespace svbfm
