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
//
// A warp, or a group of lanes of one, runs it (group_sequential_draws):
// lane g mod kW keeps corr_g in a register, the lane that owns f draws and
// broadcasts v_f - new_f with a shuffle, and every lane adds its terms for
// g > f.  No barrier runs inside
// the F steps, and corr_g gathers its terms in ascending f with the
// arithmetic of the block-wide loop it replaced, so the draws keep their
// bits.
#pragma once

#include <type_traits>

#include "svbfm_common.cuh"

namespace svbfm {

// The widest F a warp draws: corr_g of g = lane + 32 k, k < kDrawSlots, in
// registers (X8a admits F <= 303, X10b F <= 251).
constexpr int kDrawSlots = 10;

// Calls fn(std::integral_constant<int, S>) with S the slots a lane of a
// 32-lane draw of F factors needs, on the ladder 1, 2, 4, kDrawSlots the
// kernels are built at: a kernel holds S factors' values a lane in
// registers, so a narrow F keeps few (with ten slots at F = 33, 128
// registers a thread, X8a's exact mode ran 2.4x slower than with the
// block-wide draw on the H100).
template <typename Fn>
decltype(auto) with_draw_slots(int F, Fn&& fn) {
  if (F <= 32) return fn(std::integral_constant<int, 1>{});
  if (F <= 64) return fn(std::integral_constant<int, 2>{});
  if (F <= 128) return fn(std::integral_constant<int, 4>{});
  return fn(std::integral_constant<int, kDrawSlots>{});
}

// One conditional draw in two parts: s2 = draw_s2(...), which does not
// depend on the corrections of a sequential draw, and draw_from(..., s2,
// sqrtf(s2), ...); draw_one is the two in a row.  Counts into nan_c/inf_c.
// The arithmetic is written out in round-to-nearest intrinsics, fused as
// the compiler fused the plain expression 1 / (lam + alpha sh2) and
// -s2 (alpha (she - v sh2) - mu lam) [+ sqrt(s2) z] in each kernel: the
// noise term's product rounded, then -s2 t added to it in one FMA (the
// sequential draw, F = 1, X10b), or with kNoiseOnMean the mean rounded
// and the noise product added to it in one FMA (X8a's Jacobi mode), so
// that the draws keep the bits they had and no hoisting of a lane's
// invariant products out of the F steps can change one.  1 / x is the rounded reciprocal
// (__frcp_rn, as the compiler emits it): a full division gives the same
// bits but slowed X8a's Jacobi mode by 7-11 % on the H100.
__device__ __forceinline__ float draw_s2(float sh2, float lam, float alpha) {
  return __frcp_rn(__fmaf_rn(alpha, sh2, lam));
}

template <bool kNoiseOnMean = false>
__device__ __forceinline__ float draw_from(float she, float sh2, float v_c,
                                           float mu, float lam, float alpha,
                                           bool has_z, float zv, float s2,
                                           float sq, int& nan_c,
                                           int& inf_c) {
  const float t = __fmaf_rn(alpha, __fmaf_rn(-v_c, sh2, she),
                            -__fmul_rn(mu, lam));
  const float mean = __fmul_rn(-s2, t);
  float val = !has_z        ? mean
              : kNoiseOnMean ? __fmaf_rn(sq, zv, mean)
                             : __fmaf_rn(-s2, t, __fmul_rn(sq, zv));
  if (!isfinite(s2)) val = 0.f;  // uncounted
  nan_c += isnan(val) ? 1 : 0;
  inf_c += isinf(val) ? 1 : 0;
  return isfinite(val) ? val : v_c;
}

template <bool kNoiseOnMean = false>
__device__ __forceinline__ float draw_one(float she, float sh2, float v_c,
                                          float mu, float lam, float alpha,
                                          bool has_z, float zv, int& nan_c,
                                          int& inf_c) {
  const float s2 = draw_s2(sh2, lam, alpha);
  return draw_from<kNoiseOnMean>(she, sh2, v_c, mu, lam, alpha, has_z, zv,
                                 s2, __fsqrt_rn(s2), nan_c, inf_c);
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

// Moves the pair (f, g) n offsets on in the packed triangle (a thread that
// owns every n-th sum steps from one to the next without a root).
__device__ __forceinline__ void pair_step(int& f, int& g, int n, int F) {
  int p = g - f - 1 + n;
  while (f < F - 1 && p >= F - f - 1) {
    p -= F - f - 1;
    ++f;
  }
  g = f + 1 + p;
}

// The exact sequential draw of one column's F <= kW kSlots factors by a
// group of kW lanes of a warp (kW = 32: one warp, X8a; kW = 8: four
// columns a warp, X10b's one-hot buckets; kW = 4: X8a's lanes form at
// F <= 4), every lane of the warp calling
// it: acc = (s0 | sh2 | M packed), vc [F] the pre-bin values and prior
// [3, F] = (mu, lambda, z) of the group's column, complete and visible to
// the warp.  Lane f mod kW of the group draws factor f and, where `write`,
// writes v_out[f] = new_f and dv_out[f] = v_f - new_f; its NaN/Inf draws
// go to its nan_c and inf_c.  Each lane reads its factors' sums, v and
// priors and forms s2 and its root before the F steps, and each step loads
// the next step's row of M, so a step waits only on the shuffle, one FMA
// and the draw's tail.  kSlots (the factors a lane owns) is a template
// parameter so that a narrow F keeps few registers for them.
template <int kW, int kSlots>
__device__ __forceinline__ void group_sequential_draws(
    const float* acc, int F, const float* vc, const float* prior,
    float alpha, bool has_z, bool write, float* v_out, float* dv_out,
    int& nan_c, int& inf_c) {
  static_assert(kSlots >= 1 && kSlots <= kDrawSlots, "1 to 10 slots");
  static_assert(kW == 4 || kW == 8 || kW == 16 || kW == 32,
                "a group within a warp");
  const int gl = threadIdx.x & (kW - 1);
  float corr[kSlots], she[kSlots], sh2[kSlots], v[kSlots], mu[kSlots],
      lam[kSlots], zv[kSlots], s2[kSlots], sq[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int f = kW * k + gl;
    const bool own = f < F;
    corr[k] = 0.f;
    she[k] = own ? acc[f] : 0.f;
    sh2[k] = own ? acc[F + f] : 0.f;
    v[k] = own ? vc[f] : 0.f;
    mu[k] = own ? prior[f] : 0.f;
    lam[k] = own ? prior[F + f] : 0.f;
    zv[k] = own ? prior[2 * F + f] : 0.f;
    s2[k] = draw_s2(sh2[k], lam[k], alpha);
    sq[k] = __fsqrt_rn(s2[k]);
  }
  // m[k] = M_fg, g = kW k + gl, for the step's f where g > f
  float m[kSlots];
  auto m_row = [&](int f, float* out) {
    const int mrow = 2 * F + pair_index(f, f + 1, F) - (f + 1);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int g = kW * k + gl;
      out[k] = g > f && g < F ? acc[mrow + g] : 0.f;
    }
  };
  m_row(0, m);
#pragma unroll
  for (int kf = 0; kf < kSlots; ++kf) {
    if (kW * kf >= F) break;
    const int nf = min(kW, F - kW * kf);
    for (int fl = 0; fl < nf; ++fl) {
      const int f = kW * kf + fl;
      float mn[kSlots] = {};
      if (f + 1 < F) m_row(f + 1, mn);
      float d = 0.f;
      if (gl == fl) {
        const float nv =
            draw_from(__fsub_rn(she[kf], corr[kf]), sh2[kf], v[kf], mu[kf],
                      lam[kf], alpha, has_z, zv[kf], s2[kf], sq[kf], nan_c,
                      inf_c);
        d = __fsub_rn(v[kf], nv);
        if (write) {
          v_out[f] = nv;
          dv_out[f] = d;
        }
      }
      d = __shfl_sync(kFullMask, d, fl, kW);
#pragma unroll
      for (int k = kf; k < kSlots; ++k) {
        const int g = kW * k + gl;
        if (g > f && g < F) corr[k] = __fmaf_rn(d, m[k], corr[k]);
        m[k] = mn[k];
      }
    }
  }
}

// The draw by one warp (every lane calls it): kW = 32.
template <int kSlots>
__device__ __forceinline__ void warp_sequential_draws(
    const float* acc, int F, const float* vc, const float* prior,
    float alpha, bool has_z, float* v_out, float* dv_out, int& nan_c,
    int& inf_c) {
  group_sequential_draws<32, kSlots>(acc, F, vc, prior, alpha, has_z, true,
                                     v_out, dv_out, nan_c, inf_c);
}

}  // namespace svbfm
