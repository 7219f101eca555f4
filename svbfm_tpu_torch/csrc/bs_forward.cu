// X10d: the block-structure (BS) forward pass and the data-row resync of
// the native relational Gibbs/ALS sampler.
//
// Replaces the XLA gather chains of svbfm_tpu/learners/mcmc_bs.py:
//   bs_rel_moments: the relation-row moments of bs_scores (:230-234,
//     :251-258) and the qB of every factor at the v sweep's entry
//     (:700-708): per relation row rho, over its row-layout positions,
//       lin = sum w x,  qB_f = sum v_f x,  sB_f = sum (v_f x)^2;
//   bs_scores: the joined score of each data row (:215-268),
//       y = w0 + sum_p w x + sum_r lin_r[j_r]
//           + 1/2 sum_f [(s_f)^2 - s2_f],
//       s_f  = sum_p v_f x + sum_r qB_r,f[j_r],
//       s2_f = sum_p (v_f x)^2 + sum_r sB_r,f[j_r];
//   bs_resync: the data-row resync after a relation sweep (:463-468,
//     :820-824, :689-690), with j = join[n] and qO = q - qB0[j],
//       e += sum_f dy_f[j] + sum_f qO_f (qB1_f[j] - qB0_f[j]),
//       q += qB1[j] - qB0[j];
//     and, with no qB0, dy or e, the q build q += qB1[j] (:490-497).
//
// Layouts: the parameter table stab [D_all, 1+K] = (w | v^T) of K1; a
// relation's row layout rids/rvals [R, Pr] in its local attribute ids,
// which sit at rows off .. off + Dr - 1 of stab; moments [R, 1+2K] =
// (lin | qB | sB); q [N, F] row-major; dy, qB0 [R, F]; qB1 rows of
// stride ld1 (the qB channels of X10b's relation table).  bs_scores takes
// any number of relations: their joins and moment tables arrive as two
// device arrays of nrel pointers, which the wrapper builds once per set of
// tensors, and every relation's qB adds into one s_f before it is squared.
//
// Bound: bytes.  bs_scores reads each data row's ids, values and table
// rows and one moments row per relation at a data-dependent address
// (1+2K floats); bs_resync one dy/qB row per data row.  One warp per row,
// lanes over factors, as K1.
#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kResyncThreads = 256;

__global__ void rel_moments_kernel(const int* __restrict__ rids,
                                   const float* __restrict__ rvals,
                                   int64_t R, int Pr,
                                   const float* __restrict__ stab,
                                   int64_t off, int K, int k1,
                                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t rho =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (rho >= R) return;
  const int64_t ld = K + 1;
  const int* rid = rids + rho * Pr;
  const float* rx = rvals + rho * Pr;
  float* o = out + rho * (1 + 2 * K);
  for (int f = lane; f < K; f += 32) {
    float qb = 0.f, sb = 0.f;
    for (int p = 0; p < Pr; ++p) {
      const float d = stab[(off + rid[p]) * ld + 1 + f] * rx[p];
      qb += d;
      sb += d * d;
    }
    o[1 + f] = qb;
    o[1 + K + f] = sb;
  }
  if (lane == 0) {
    float lin = 0.f;
    if (k1)
      for (int p = 0; p < Pr; ++p) lin += stab[(off + rid[p]) * ld] * rx[p];
    o[0] = lin;
  }
}

__global__ void bs_scores_kernel(const float* __restrict__ stab, int K,
                                 const float* __restrict__ w0,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ vals, int64_t N,
                                 int P, int nrel,
                                 const int* const* __restrict__ joins,
                                 const float* const* __restrict__ moms,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const int64_t ld = K + 1;
  const int64_t ldm = 1 + 2 * K;
  const int* rid = ids + n * P;
  const float* rx = vals + n * P;
  float part = 0.f;
  for (int f = lane; f < K; f += 32) {
    float s = 0.f, s2 = 0.f;
    for (int p = 0; p < P; ++p) {
      const float d = stab[rid[p] * ld + 1 + f] * rx[p];
      s += d;
      s2 += d * d;
    }
    for (int r = 0; r < nrel; ++r) {
      const float* m = moms[r] + static_cast<int64_t>(joins[r][n]) * ldm;
      s += m[1 + f];
      s2 += m[1 + K + f];
    }
    part += s * s - s2;
  }
  part = svbfm::warp_sum(part);
  if (lane == 0) {
    float acc = *w0;
    for (int p = 0; p < P; ++p) acc += stab[rid[p] * ld] * rx[p];
    for (int r = 0; r < nrel; ++r)
      acc += moms[r][static_cast<int64_t>(joins[r][n]) * ldm];
    out[n] = acc + 0.5f * part;
  }
}

template <int kLanes>
__global__ void resync_kernel(const int* __restrict__ join, int64_t N, int F,
                              const float* __restrict__ dy,
                              const float* __restrict__ qb1, int64_t ld1,
                              const float* __restrict__ qb0,
                              float* __restrict__ q, float* __restrict__ e) {
  const int lane = threadIdx.x % kLanes;
  const int64_t n = static_cast<int64_t>(blockIdx.x) *
                        (kResyncThreads / kLanes) + threadIdx.x / kLanes;
  if (n >= N) return;
  const int64_t j = join[n];
  float de = 0.f;
  for (int f = lane; f < F; f += kLanes) {
    if (dy != nullptr) de += dy[j * F + f];
    if (qb1 == nullptr) continue;
    const float b0 = qb0 != nullptr ? qb0[j * F + f] : 0.f;
    const float dq = qb1[j * ld1 + f] - b0;
    const int64_t o = n * F + f;
    if (e != nullptr) de += (q[o] - b0) * dq;
    q[o] += dq;
  }
  de = svbfm::row_sum<kLanes>(de);
  if (e != nullptr && lane == 0) e[n] += de;
}

inline unsigned warp_blocks(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// moments [R, 1+2K] of one relation from stab [D_all, 1+K] rows off + id.
SVBFM_EXPORT int svbfm_bs_rel_moments(const int* rids, const float* rvals,
                                      int64_t R, int Pr, const float* stab,
                                      int64_t off, int K, int k1, float* out,
                                      cudaStream_t stream) {
  rel_moments_kernel<<<warp_blocks(R), 32 * kWarpsPerBlock, 0, stream>>>(
      rids, rvals, R, Pr, stab, off, K, k1, out);
  return static_cast<int>(cudaGetLastError());
}

// scores [N] from the main rows ids/vals [N, P] and nrel relations: joins
// (a device array of nrel pointers to int [N]) and moms (a device array of
// nrel pointers to [R_r, 1+2K]).
SVBFM_EXPORT int svbfm_bs_scores(const float* stab, int K, const float* w0,
                                 const int* ids, const float* vals, int64_t N,
                                 int P, int nrel, const int* const* joins,
                                 const float* const* moms, float* out,
                                 cudaStream_t stream) {
  if (nrel < 0) return static_cast<int>(cudaErrorInvalidValue);
  bs_scores_kernel<<<warp_blocks(N), 32 * kWarpsPerBlock, 0, stream>>>(
      stab, K, w0, ids, vals, N, P, nrel, joins, moms, out);
  return static_cast<int>(cudaGetLastError());
}

// The resync of q [N, F] and e [N] through join [N]; any of dy [R, F], qb1
// (rows of stride ld1), qb0 [R, F], q and e may be nullptr (see the top).
SVBFM_EXPORT int svbfm_bs_resync(const int* join, int64_t N, int F,
                                 const float* dy, const float* qb1,
                                 int64_t ld1, const float* qb0, float* q,
                                 float* e, cudaStream_t stream) {
  if (F >= 2) {
    const int64_t rows = kResyncThreads / 32;
    resync_kernel<32><<<static_cast<unsigned>((N + rows - 1) / rows),
                        kResyncThreads, 0, stream>>>(join, N, F, dy, qb1, ld1,
                                                     qb0, q, e);
  } else {
    resync_kernel<1><<<static_cast<unsigned>(
                           (N + kResyncThreads - 1) / kResyncThreads),
                       kResyncThreads, 0, stream>>>(join, N, F, dy, qb1, ld1,
                                                    qb0, q, e);
  }
  return static_cast<int>(cudaGetLastError());
}
