// X12a, X12b: the probit task's train-row latent update and test-row eval
// (-task c under batch VB, online VB, Gibbs MCMC, ALS and block structure).
//
// Replaces the elementwise XLA chains of svbfm_tpu/learners/vb.py:
// _eval_and_resample (:1002-1019), mcmc.py:_eval_tail's classification
// branch (:1046-1068) and :_resample_class_targets_jax (:1072-1090), and
// vb_online.py's classification eval (:1062-1068): about 15 ops each (the
// Abramowitz-Stegun erf, exp, erfinv, log10, two sums) that PyTorch would
// run as as many launches over the rows.
//
// The arithmetic is the JAX package's, op by op, in float32: the
// reference's erf polynomial (base.py:201-225) with expf (not __expf), its
// 3.141, and for the Gibbs draw Giles' single-precision erfinv polynomial,
// the one XLA lowers jax.scipy.special.erfinv to (never erfinvf, whose
// approximation differs: near cdf = 1 - 1e-7 its slope turns an ulp into a
// visible change of e).  The library is built with -fmad=false, so no
// multiply-add is contracted and each operation rounds as the plain twin's
// (kernels/probit.py) does; clips let a NaN through, as jnp.clip does.
//
// X12a probit_latent, one thread a row: e <- T(e) - e (VB), e <- e - T(e)
//   (ALS), T the truncated-normal mean by the sign of y (y >= 0: z > 0);
//   Gibbs: lo = Phi(-e), cdf = y >= 0 ? lo + u (1 - lo) : u lo, clipped to
//   [1e-7, 1 - 1e-7], e <- e - (e + sqrt(2) erfinv(2 cdf - 1)).  Bound: the
//   bytes, e, y (and u) read and e written once: 12-16 B a row, ~16 MB at
//   1M rows (~5 us at 3.35 TB/s); its ~60 operations a row are far below
//   the float32 peak's share.
// X12b probit_eval, a fixed grid (a function of N alone) of 256-thread
//   blocks, each thread a block-stride run of rows: prob = Phi(score);
//   Gibbs adds prob to psum_all and, from iteration 5, psum_but5 (in
//   place) and scores the posterior mean pm = psum_all / (it + 1); the
//   four sums (hits and log10 likelihood of pm, and of prob) are taken in
//   a fixed order per thread, then by a fixed tree per block into a
//   partials buffer [blocks, 4]; the last block to finish (a ticket
//   counter, left at zero for the next launch) adds the partials in block
//   order and writes out [4] = (acc, loglik, acc_this, loglik_this), each
//   sum over nt.  The same inputs give the same bits on every launch.
//   Bound: ~2.8 MB at the 100k test rows (scores, target, valid; psum read
//   and written), under 1 us at HBM rate: the launch floor rules it.
#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModeVB = 0, kModeALS = 1, kModeGibbs = 2;

// jnp.clip: a NaN stays NaN
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the reference's erf (src/util/random.h:47-62)
__device__ __forceinline__ float ref_erf(float x) {
  const float t = 1.0f / (1.0f + 0.3275911f * fabsf(x));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float r = 1.0f - poly * expf(-x * x);
  return x >= 0.f ? r : -r;
}

__device__ __forceinline__ float ref_cdf(float x) {
  return 0.5f + 0.5f * ref_erf(0.707106781f * x);
}

// E[z | z > 0] and E[z | z < 0], z ~ N(mu, 1), the reference's 3.141
__device__ __forceinline__ float trunc_mean(float mu, bool positive) {
  const float phi = expf(-mu * mu / 2.0f) / sqrtf(3.141f * 2.0f);
  const float Phi = ref_cdf(-mu);
  return positive ? mu + phi / (1.0f - Phi) : mu - phi / Phi;
}

// Giles' single-precision erfinv, as XLA expands it
__device__ __forceinline__ float erfinv_giles(float x) {
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  const float c_lt[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                         -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                         -0.00417768164f,  0.246640727f,    1.50140941f};
  const float c_gt[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                         -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                         0.00943887047f,   1.00167406f,     2.83297682f};
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? c_lt[0] : c_gt[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? c_lt[i] : c_gt[i]) + p * w;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : p * x;
}

__global__ void __launch_bounds__(kThreads)
    probit_latent_kernel(float* __restrict__ e, const float* __restrict__ y,
                         const float* __restrict__ u, int64_t n, int mode) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float ei = e[i];
  const bool pos = y[i] >= 0.f;
  if (mode == kModeGibbs) {
    const float lo = ref_cdf(-ei);
    const float ui = u[i];
    float cdf = pos ? lo + ui * (1.0f - lo) : ui * lo;
    cdf = clip_nan(cdf, 1e-7f, 1.0f - 1e-7f);
    const float sampled = ei + sqrtf(2.0f) * erfinv_giles(2.0f * cdf - 1.0f);
    e[i] = ei - sampled;
  } else {
    const float t = trunc_mean(ei, pos);
    e[i] = mode == kModeVB ? t - ei : ei - t;
  }
}

struct Eval {
  const float* scores;
  const float* target;
  const float* valid;
  int64_t n;
  float* psum_all;   // Gibbs: updated in place (else null)
  float* psum_but5;  // Gibbs
  int it;            // Gibbs: this iteration (0-based)
  float nt;          // the eval's row count
  float* partials;   // [gridDim.x, 4]
  unsigned* ticket;  // zero before the launch, zero after it
  float* out;        // [4]
};

// a hit and the log10 likelihood of probability p for target yt
__device__ __forceinline__ void score_row(float p, float yt, float valid,
                                          float& hit, float& ll) {
  const bool h = (p >= 0.5f && yt > 0.f) || (p < 0.5f && yt < 0.f);
  hit += (h ? 1.0f : 0.0f) * valid;
  const float m = (yt + 1.0f) * 0.5f;
  const float pll = clip_nan(p, 0.01f, 0.99f);
  ll += (m * log10f(pll) + (1.0f - m) * log10f(1.0f - pll)) * valid;
}

__global__ void __launch_bounds__(kThreads) probit_eval_kernel(Eval a) {
  __shared__ float red[kThreads / 32][4];
  __shared__ bool last;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < a.n; i += stride) {
    const float prob = ref_cdf(a.scores[i]);
    const float yt = a.target[i], valid = a.valid[i];
    float pm = prob;
    if (a.psum_all != nullptr) {
      const float all = a.psum_all[i] + prob;
      a.psum_all[i] = all;
      if (a.it >= 5) a.psum_but5[i] += prob;
      pm = all / (static_cast<float>(a.it) + 1.0f);
    }
    score_row(pm, yt, valid, s[0], s[1]);
    score_row(prob, yt, valid, s[2], s[3]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = svbfm::warp_sum(s[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) v += red[w][threadIdx.x];
    a.partials[blockIdx.x * 4 + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x < 4) {
    const volatile float* part = a.partials;
    float v = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b) v += part[b * 4 + threadIdx.x];
    const float mean = v / a.nt;
    a.out[threadIdx.x] = threadIdx.x % 2 == 0 ? mean : -mean;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

}  // namespace

// X12a over e [n] in place; y [n]; u [n] (Gibbs) or null; mode 0 VB,
// 1 ALS, 2 Gibbs.
SVBFM_EXPORT int svbfm_probit_latent(float* e, const float* y, const float* u,
                                     int64_t n, int mode,
                                     cudaStream_t stream) {
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  probit_latent_kernel<<<blocks, kThreads, 0, stream>>>(e, y, u, n, mode);
  return static_cast<int>(cudaGetLastError());
}

// X12b on ``blocks`` blocks (the wrapper's eval_blocks(n): a function of n
// alone, so the sums' order is too); psum_all/psum_but5 null outside
// Gibbs; ticket a zeroed uint32 that the launch leaves at zero; partials
// [blocks, 4].
SVBFM_EXPORT int svbfm_probit_eval(const float* scores, const float* target,
                                   const float* valid, int64_t n,
                                   float* psum_all, float* psum_but5, int it,
                                   float nt, int blocks, float* partials,
                                   unsigned* ticket, float* out,
                                   cudaStream_t stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Eval a{scores, target, valid, n, psum_all, psum_but5, it, nt, partials,
         ticket, out};
  probit_eval_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
