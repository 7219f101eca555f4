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
// Rows go by chunks of 4: thread t of the grid takes chunks t, t + T, ...
// (T the grid's threads; X12a's grid has a thread a chunk), each as one
// 16-byte load of every array where all its pointers are 16-byte aligned,
// else as four 4-byte loads (a view such as e[1:]); the N % 4 rows past
// the last chunk go to the grid's first threads, one each, in the same
// launch.  Which thread takes a row does not depend on the alignment.
//
// X12a probit_latent: e <- T(e) - e (VB), e <- e - T(e) (ALS), T the
//   truncated-normal mean by the sign of y (y >= 0: z > 0); Gibbs: lo =
//   Phi(-e), cdf = y >= 0 ? lo + u (1 - lo) : u lo, clipped to [1e-7,
//   1 - 1e-7], e <- e - (e + sqrt(2) erfinv(2 cdf - 1)).  The mode is a
//   template parameter (a run-time mode in the row loop costs its branch
//   every row).  T divides once, by the chosen side's denominator (the
//   twin, like the select it mirrors, forms both quotients; the bits are
//   the same).  A thread a chunk, the grid as many blocks as the chunks
//   need (the wrapper's latent_blocks): one wave of 256-thread blocks at
//   1M rows.  Bound: the bytes, e, y (and u) read and e written once:
//   12-16 B a row, ~12-16 MB at 1M rows (3.6-4.8 us at 3.35 TB/s); its
//   ~90 (mean modes) to ~150 (Gibbs) instructions a row, uncontracted,
//   take 3-5 us of the FP32 pipes, so the compute is as long as the
//   reads, and one division less a row counts.
// X12b probit_eval: prob = Phi(score); Gibbs adds prob to psum_all and,
//   from iteration 5, psum_but5 (in place) and scores the posterior mean
//   pm = psum_all / (it + 1); the four sums (hits and log10 likelihood of
//   pm, and of prob) are taken in a fixed order per thread (its chunks,
//   each chunk's rows in order, then its tail row), then by a fixed
//   butterfly over each warp and over the block's warps, then over the
//   blocks in a fixed order: out [4] = (acc, loglik, acc_this,
//   loglik_this), each sum over nt.  The geometry is a function of N
//   alone, so the sums' order is; the same inputs give the same bits on
//   every launch.  256-thread blocks, a chunk a thread (98 blocks at the
//   100k test rows); each block's four sums go out as one 16-byte store to
//   its partials row, then a release-acquire ticket (one atom.acq_rel, no
//   fence); the last block's warp 0 reads the partials 32 rows at a time
//   (lane l: rows l, l + 32, ...) and adds them by a fixed butterfly.  The
//   ticket is left at zero for the next launch.  Bound: ~2.8 MB at the
//   100k test rows (scores, target, valid; psum read and written), under
//   1 us at HBM rate: the launch floor and the chain of one load round,
//   the block's sums, the ticket and the tail rule it.  Smaller blocks
//   (more SMs, more tickets on one address) were slower, and so was one
//   cluster of 16 blocks (16 SMs carry every row's ~120 instructions) or
//   a cluster-of-8 combine.
#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModeVB = 0, kModeALS = 1, kModeGibbs = 2;

// jnp.clip: a NaN stays NaN
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

using svbfm::ref_cdf;  // the reference's Phi (svbfm_common.cuh)

// E[z | z > 0] = mu + phi / (1 - Phi) and E[z | z < 0] = mu - phi / Phi,
// z ~ N(mu, 1), Phi = Phi(-mu), the reference's 3.141; one division, by the
// chosen side's denominator
__device__ __forceinline__ float trunc_mean(float mu, bool positive) {
  const float phi = expf(-mu * mu / 2.0f) / sqrtf(3.141f * 2.0f);
  const float Phi = ref_cdf(-mu);
  const float q = phi / (positive ? 1.0f - Phi : Phi);
  return positive ? mu + q : mu - q;
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

// one row of X12a: the new e of a row with residual ei, target yi and (in
// the Gibbs mode) uniform ui
template <int kMode>
__device__ __forceinline__ float latent_row(float ei, float yi, float ui) {
  const bool pos = yi >= 0.f;
  if constexpr (kMode == kModeGibbs) {
    const float lo = ref_cdf(-ei);
    float cdf = pos ? lo + ui * (1.0f - lo) : ui * lo;
    cdf = clip_nan(cdf, 1e-7f, 1.0f - 1e-7f);
    const float sampled = ei + sqrtf(2.0f) * erfinv_giles(2.0f * cdf - 1.0f);
    return ei - sampled;
  } else {
    const float t = trunc_mean(ei, pos);
    return kMode == kModeVB ? t - ei : ei - t;
  }
}

// four rows from p (a chunk): one 16-byte load (kVec, p 16-byte aligned)
// or four 4-byte loads; kRO: read-only for the kernel's life (the
// non-coherent path)
template <bool kVec, bool kRO = true>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kVec && kRO) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else if constexpr (kVec) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (kRO) {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  } else {
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  }
}

template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
    probit_latent_kernel(float* __restrict__ e, const float* __restrict__ y,
                         const float* __restrict__ u, int64_t n) {
  const int64_t n4 = n >> 2;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c < n4) {
    float4 ev = load4<kVec, false>(e + 4 * c);
    const float4 yv = load4<kVec>(y + 4 * c);
    float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kMode == kModeGibbs) uv = load4<kVec>(u + 4 * c);
    ev.x = latent_row<kMode>(ev.x, yv.x, uv.x);
    ev.y = latent_row<kMode>(ev.y, yv.y, uv.y);
    ev.z = latent_row<kMode>(ev.z, yv.z, uv.z);
    ev.w = latent_row<kMode>(ev.w, yv.w, uv.w);
    store4<kVec>(e + 4 * c, ev);
  }
  const int64_t r = 4 * n4 + c;  // the N % 4 rows past the chunks
  if (r < n)
    e[r] = latent_row<kMode>(e[r], y[r],
                             kMode == kModeGibbs ? u[r] : 0.f);
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
  float4* partials;  // [gridDim.x] (acc, ll, acc_this, ll_this)
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

// one test row's Phi, its accumulators (Gibbs) and its four sums in s
template <bool kGibbs>
__device__ __forceinline__ void eval_row(const Eval& a, float score,
                                         float yt, float valid, float& all,
                                         float& but5, float4& s) {
  const float prob = ref_cdf(score);
  float pm = prob;
  if constexpr (kGibbs) {
    all = all + prob;
    if (a.it >= 5) but5 += prob;
    pm = all / (static_cast<float>(a.it) + 1.0f);
  }
  score_row(pm, yt, valid, s.x, s.y);
  score_row(prob, yt, valid, s.z, s.w);
}

// this thread's rows (its chunks in order, then its tail row), T threads in
// all, its sums in s
template <bool kVec, bool kGibbs>
__device__ __forceinline__ float4 eval_rows(const Eval& a, int64_t first,
                                            int64_t T) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t n4 = a.n >> 2;
  const bool but5 = kGibbs && a.it >= 5;
  for (int64_t c = first; c < n4; c += T) {
    const float4 sc = load4<kVec>(a.scores + 4 * c);
    const float4 yt = load4<kVec>(a.target + 4 * c);
    const float4 va = load4<kVec>(a.valid + 4 * c);
    float4 al = make_float4(0.f, 0.f, 0.f, 0.f), b5 = al;
    if constexpr (kGibbs) {
      al = load4<kVec, false>(a.psum_all + 4 * c);
      if (but5) b5 = load4<kVec, false>(a.psum_but5 + 4 * c);
    }
    eval_row<kGibbs>(a, sc.x, yt.x, va.x, al.x, b5.x, s);
    eval_row<kGibbs>(a, sc.y, yt.y, va.y, al.y, b5.y, s);
    eval_row<kGibbs>(a, sc.z, yt.z, va.z, al.z, b5.z, s);
    eval_row<kGibbs>(a, sc.w, yt.w, va.w, al.w, b5.w, s);
    if constexpr (kGibbs) {
      store4<kVec>(a.psum_all + 4 * c, al);
      if (but5) store4<kVec>(a.psum_but5 + 4 * c, b5);
    }
  }
  const int64_t r = 4 * n4 + first;
  if (r < a.n) {
    float al = 0.f, b5 = 0.f;
    if constexpr (kGibbs) {
      al = a.psum_all[r];
      if (but5) b5 = a.psum_but5[r];
    }
    eval_row<kGibbs>(a, a.scores[r], a.target[r], a.valid[r], al, b5, s);
    if constexpr (kGibbs) {
      a.psum_all[r] = al;
      if (but5) a.psum_but5[r] = b5;
    }
  }
  return s;
}

__device__ __forceinline__ float4 warp_sum4(float4 v) {
  return make_float4(svbfm::warp_sum(v.x), svbfm::warp_sum(v.y),
                     svbfm::warp_sum(v.z), svbfm::warp_sum(v.w));
}

// the block's four sums (valid in warp 0): each warp's by a butterfly, then
// the warps' by a butterfly in warp 0 (lanes past the warps add zeros)
template <int kBlock>
__device__ __forceinline__ float4 block_sum4(float4 s) {
  __shared__ float4 red[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum4(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kBlock / 32 ? red[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    s = warp_sum4(s);
  }
  return s;
}

__device__ __forceinline__ void write_out(const Eval& a, float4 s) {
  a.out[0] = s.x / a.nt;
  a.out[1] = -(s.y / a.nt);
  a.out[2] = s.z / a.nt;
  a.out[3] = -(s.w / a.nt);
}

// the ticket's increment: a release of this thread's partials store and an
// acquire of every earlier block's
__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

template <bool kVec, bool kGibbs>
__global__ void __launch_bounds__(kThreads) probit_eval_kernel(Eval a) {
  __shared__ bool last;
  const int64_t T = static_cast<int64_t>(gridDim.x) * kThreads;
  const float4 s = block_sum4<kThreads>(eval_rows<kVec, kGibbs>(
      a, static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x, T));
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = s;
    last = ticket_add(a.ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // lane l adds partials l, l + 32, ... in order, then a fixed butterfly
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (unsigned b = threadIdx.x; b < gridDim.x; b += 32) {
    const float4 p = __ldcg(a.partials + b);
    v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
  }
  v = warp_sum4(v);
  if (threadIdx.x == 0) {
    write_out(a, v);
    *a.ticket = 0u;
  }
}

template <int kMode>
void launch_latent(float* e, const float* y, const float* u, int64_t n,
                   unsigned blocks, bool vec, cudaStream_t stream) {
  if (vec)
    probit_latent_kernel<kMode, true>
        <<<blocks, kThreads, 0, stream>>>(e, y, u, n);
  else
    probit_latent_kernel<kMode, false>
        <<<blocks, kThreads, 0, stream>>>(e, y, u, n);
}

}  // namespace

// X12a over e [n] in place; y [n]; u [n] (Gibbs) or null; mode 0 VB,
// 1 ALS, 2 Gibbs; ``blocks`` of 256 threads, a thread a chunk of 4 rows
// (the wrapper's latent_blocks).
SVBFM_EXPORT int svbfm_probit_latent(float* e, const float* y, const float* u,
                                     int64_t n, int mode, int blocks,
                                     cudaStream_t stream) {
  if (n == 0) return 0;
  if (blocks < 1 || static_cast<int64_t>(blocks) * kThreads < n / 4 ||
      mode < kModeVB || mode > kModeGibbs)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = svbfm::aligned(e, 16) && svbfm::aligned(y, 16) &&
                   svbfm::aligned(u, 16);
  const unsigned b = static_cast<unsigned>(blocks);
  if (mode == kModeVB)
    launch_latent<kModeVB>(e, y, u, n, b, vec, stream);
  else if (mode == kModeALS)
    launch_latent<kModeALS>(e, y, u, n, b, vec, stream);
  else
    launch_latent<kModeGibbs>(e, y, u, n, b, vec, stream);
  return static_cast<int>(cudaGetLastError());
}

// X12b on ``blocks`` blocks (the wrapper's eval_blocks(n): a function of n
// alone, so the sums' order is too); psum_all/psum_but5 null outside
// Gibbs; ``scratch``: a uint32 ticket, zero, that the launch leaves at
// zero, then the blocks' 16-byte partials rows from byte 16.
SVBFM_EXPORT int svbfm_probit_eval(const float* scores, const float* target,
                                   const float* valid, int64_t n,
                                   float* psum_all, float* psum_but5, int it,
                                   float nt, int blocks, float* scratch,
                                   float* out, cudaStream_t stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Eval a{scores, target, valid, n, psum_all, psum_but5, it, nt,
         reinterpret_cast<float4*>(scratch + 4),
         reinterpret_cast<unsigned*>(scratch), out};
  const bool vec = svbfm::aligned(scores, 16) && svbfm::aligned(target, 16) &&
                   svbfm::aligned(valid, 16) && svbfm::aligned(psum_all, 16) &&
                   svbfm::aligned(psum_but5, 16);
  const unsigned b = static_cast<unsigned>(blocks);
  if (vec) {
    if (psum_all != nullptr)
      probit_eval_kernel<true, true><<<b, kThreads, 0, stream>>>(a);
    else
      probit_eval_kernel<true, false><<<b, kThreads, 0, stream>>>(a);
  } else {
    if (psum_all != nullptr)
      probit_eval_kernel<false, true><<<b, kThreads, 0, stream>>>(a);
    else
      probit_eval_kernel<false, false><<<b, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
