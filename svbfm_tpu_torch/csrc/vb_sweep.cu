// K2-K4: one factor block of the batch VBFM coordinate sweep: fast mode
// (all K factors in one block, the linear-term update riding along) or
// exact mode (blocks of factor_block factors).  K2 and K4 also serve the
// online VB factor sweep (vb_online.py:444 _qtz_generic, :561-580), whose
// column statistics are K6 (ovb_sweep.cu).  K2's q channel alone is X8d,
// the q cache of the MCMC/ALS sweep (mcmc_sweep.cu), and K4 at F = 0 is
// also MCMC's w patch (with no t cache).
//
// Replaces svbfm_tpu/learners/vb.py:vb_v_block_update, whose three XLA
// gather chains are
//   K2 build_qt   (vb.py:317-332)  row caches q, tq, tz;
//   K3 tile_stats (vb.py:382-405) + the closed-form update (vb.py:449-487)
//                                  per-column statistics of one [C, L] bucket;
//   K4 patch_tile (vb.py:508-568)  the per-bin row-cache patch; at F = 0
//                                  it is also the w patch of the standalone
//                                  linear-term sweep (vb.py:149-157,
//                                  vb_online.py:270-282).
//
// Layouts.  Row caches q/tq/tz are [N, F] row-major (the JAX package keeps
// [F, N] for the TPU's (8,128) tiling): one row's F factors are one
// contiguous run, which a warp reads in one transaction.  mu/sigma tables
// are [D, F].  The per-bin patch table ptab is [D, CH], CH = 5F (+2 with
// the w rider), channels (mu_old, sig_old, dmu, dsig, dmu2 [, wdmu, wdsig]);
// mu_old/sig_old are the PRE-BIN snapshot every bucket of the bin and the
// patch read, so K3 may write the new values into mu/sigma in place.
//
// Bound: memory latency of the random row gathers (each row cache read is
// F floats at a data-dependent address); FLOPs are negligible.  The design
// keeps every gather one contiguous run per row and uses 64-bit offsets for
// row * channel arithmetic.
#include "svbfm_common.cuh"

namespace {

// ---- K2: q = sum_p mu x, tq = sum_p sig x^2, tz = sum_p mu^2 x^2 ----------
// One thread per (row, factor), factor fastest: the table reads of one row
// and the cache writes are contiguous across a warp.  kQOnly builds q alone
// (X8d, the MCMC/ALS q cache, mcmc.py:337-359 and :824-826): tq and tz are
// neither computed nor written.
template <bool kQOnly>
__global__ void build_qt_kernel(const float* __restrict__ ptab, int64_t ld,
                                int F, const int* __restrict__ ids,
                                const float* __restrict__ vals, int64_t N,
                                int P, float* __restrict__ q,
                                float* __restrict__ tq,
                                float* __restrict__ tz) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N * F) return;
  const int64_t n = i / F;
  const int f = static_cast<int>(i - n * F);
  float qa = 0.f, tqa = 0.f, tza = 0.f;
  for (int p = 0; p < P; ++p) {
    const float* g = ptab + ids[n * P + p] * ld;
    const float x = vals[n * P + p];
    const float mu = g[f];
    qa += mu * x;
    if (!kQOnly) {
      const float x2 = x * x;
      tqa += g[F + f] * x2;
      tza += mu * mu * x2;
    }
  }
  q[i] = qa;
  if (!kQOnly) {
    tq[i] = tqa;
    tz[i] = tza;
  }
}

// ---- K3: per-column statistics + closed-form update of one bucket --------
// One block per column c of the [C, L] bucket; threadIdx.x = factor lane
// (32 factors per blockIdx.y), threadIdx.y strides over the L entries.
// The bucket's padding entries carry x = 0 (at a real row), so they add
// exactly zero, as in the JAX code: no mask.
constexpr int kStatRows = 8;

__global__ void col_stats_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ sx2, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ tq, int F,
    float* __restrict__ ptab, int CH, float* __restrict__ mu_t,
    float* __restrict__ sig_t, const float* __restrict__ sv,
    const float* __restrict__ alpha_p, float* __restrict__ mu_w,
    float* __restrict__ sig_w, const float* __restrict__ sigma_w,
    int* __restrict__ nans) {
  __shared__ float s_vm[kStatRows][32];
  __shared__ float s_vs[kStatRows][32];
  __shared__ float s_sxe[kStatRows];
  const int c = blockIdx.x;
  const int fx = threadIdx.x;
  const int ly = threadIdx.y;
  const int f = blockIdx.y * 32 + fx;
  const bool active = f < F;
  const int64_t col = cols[c];
  float* prow = ptab + col * CH;
  float mu_c = 0.f, sig_c = 0.f;
  if (active) {
    mu_c = prow[f];
    sig_c = prow[F + f];
  }
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  float vm = 0.f, vs = 0.f, sxe = 0.f;
  for (int l = ly; l < L; l += kStatRows) {
    const int64_t r = crow[l];
    const float xv = cx[l];
    const float ev = e[r];
    sxe += xv * ev;
    if (active) {
      const float h = q[r * F + f] - xv * mu_c;
      const float h1 = tq[r * F + f] - xv * xv * sig_c;
      vm += xv * h * (ev + xv * mu_c * h);
      vs += xv * xv * (h * h + h1);
    }
  }
  s_vm[ly][fx] = vm;
  s_vs[ly][fx] = vs;
  if (fx == 0) s_sxe[ly] = sxe;
  __syncthreads();
  if (ly != 0) return;  // no barrier follows
  vm = 0.f;
  vs = 0.f;
  for (int j = 0; j < kStatRows; ++j) {
    vm += s_vm[j][fx];
    vs += s_vs[j][fx];
  }
  const float alpha = *alpha_p;
  const int g = group[c];
  if (active) {
    // vb.py:449-469: sigma' candidate -> count -> keep-finite,
    // mu' = sigma'_kept alpha vm -> count -> keep-finite
    const float sig_cand = 1.f / (sv[g * F + f] + alpha * vs);
    int bad = isfinite(sig_cand) ? 0 : 1;
    const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    const float mu_cand = sig_new * alpha * vm;
    bad += isfinite(mu_cand) ? 0 : 1;
    const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    mu_t[col * F + f] = mu_new;
    sig_t[col * F + f] = sig_new;
    prow[2 * F + f] = mu_new - mu_c;
    prow[3 * F + f] = sig_new - sig_c;
    prow[4 * F + f] = mu_new * mu_new - mu_c * mu_c;
    if (bad) atomicAdd(&nans[0], bad);
  }
  if (mu_w != nullptr && blockIdx.y == 0 && fx == 0) {
    // merged linear-term update (vb.py:471-487): the mu candidate uses the
    // kept sigma, the nan count the raw candidates; wdmu = old - new
    float sxe_t = 0.f;
    for (int j = 0; j < kStatRows; ++j) sxe_t += s_sxe[j];
    const float wmu_c = mu_w[col];
    const float wsig_c = sig_w[col];
    const float sxx = sx2[c];
    const float wsig_cand = 1.f / (sigma_w[g] + alpha * sxx);
    const float wsig_new = isfinite(wsig_cand) ? wsig_cand : wsig_c;
    const float wmu_cand = wsig_new * alpha * (sxe_t + wmu_c * sxx);
    const int bad = (isfinite(wsig_cand) ? 0 : 1) + (isfinite(wmu_cand) ? 0 : 1);
    const float wmu_new = isfinite(wmu_cand) ? wmu_cand : wmu_c;
    mu_w[col] = wmu_new;
    sig_w[col] = wsig_new;
    prow[5 * F] = wmu_c - wmu_new;
    prow[5 * F + 1] = wsig_new - wsig_c;
    if (bad) atomicAdd(&nans[1], bad);
  }
}

// ---- K4: per-bin row-cache patch ------------------------------------------
// kLanes threads per row, lanes over factors: a warp (32) at F >= 2; one
// thread (1) at F = 1 (exact-mode VB, the online-VB chunks) and at F = 0,
// the w patch, where a warp would idle 31 lanes and pay two 5-step shuffle
// sums a position for one product.  The launch picks kLanes by F.  kSeq
// (batch VB): positions are walked in order
// p = 0..P-1 and q/tq/tz change between positions (vb.py:523-549).  !kSeq
// (online VB, vb_online.py:561-580): every position reads the caches from
// before the patch and the cache increments are applied after the last
// position.  The two agree wherever a row has at most one entry in the bin
// (conflict-free bins).  Template parameters and not runtime flags, so the
// batch-VB loop compiles as it did alone.  Each row owns its cache slots,
// so the in-place update has no races.
constexpr int kPatchThreads = 256;

template <bool kSeq, int kLanes>
__global__ void patch_rows_kernel(const float* __restrict__ ptab, int CH,
                                  int F, int merge_w,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ vals, int64_t N,
                                  int P, float* __restrict__ q,
                                  float* __restrict__ tq,
                                  float* __restrict__ tz,
                                  float* __restrict__ e,
                                  float* __restrict__ t) {
  const int lane = threadIdx.x % kLanes;
  const int64_t n = static_cast<int64_t>(blockIdx.x) *
                        (kPatchThreads / kLanes) + threadIdx.x / kLanes;
  if (n >= N) return;  // a row's lanes leave together
  // only the w patch of MCMC has no t cache (t == nullptr); K4 at F >= 1
  // always patches t: its wrapper requires one, so at kLanes == 1 the test
  // below is true for F = 1, and at kLanes == 32 it is known at compile time
  const bool has_t = kLanes == 32 || t != nullptr;
  float ev = e[n];
  float tv = has_t ? t[n] : 0.f;
  for (int p = 0; p < P; ++p) {
    const float* g = ptab + static_cast<int64_t>(ids[n * P + p]) * CH;
    const float xv = vals[n * P + p];
    const float x2 = xv * xv;
    float esum = 0.f, tsum = 0.f;
    for (int f = lane; f < F; f += kLanes) {
      const float mu_e = g[f];
      const float sig_e = g[F + f];
      const float dmu = g[2 * F + f];
      const float dsig = g[3 * F + f];
      const float dmu2 = g[4 * F + f];
      const int64_t o = n * F + f;
      const float qv = q[o], tqv = tq[o], tzv = tz[o];
      const float he = xv * (qv - xv * mu_e);
      const float h1e = x2 * (tqv - x2 * sig_e);
      const float h2e = x2 * (tzv - x2 * mu_e * mu_e);
      if (kSeq) {
        q[o] = qv + xv * dmu;
        tq[o] = tqv + x2 * dsig;
        tz[o] = tzv + x2 * dmu2;
      }
      esum += he * dmu;
      tsum += (h1e + h2e) * dsig + h1e * dmu2;
    }
    ev = ev - svbfm::row_sum<kLanes>(esum);
    tv = tv + svbfm::row_sum<kLanes>(tsum);
    if (merge_w) {
      ev = ev + xv * g[5 * F];
      tv = tv + xv * xv * g[5 * F + 1];
    }
  }
  if (!kSeq) {
    for (int f = lane; f < F; f += kLanes) {
      const int64_t o = n * F + f;
      float dq = 0.f, dtq = 0.f, dtz = 0.f;
      for (int p = 0; p < P; ++p) {
        const float* g = ptab + static_cast<int64_t>(ids[n * P + p]) * CH;
        const float xv = vals[n * P + p];
        const float x2 = xv * xv;
        dq += xv * g[2 * F + f];
        dtq += x2 * g[3 * F + f];
        dtz += x2 * g[4 * F + f];
      }
      q[o] += dq;
      tq[o] += dtq;
      tz[o] += dtz;
    }
  }
  if (lane == 0) {
    e[n] = ev;
    if (has_t) t[n] = tv;
  }
}

}  // namespace

// ptab [D, ld] with mu in channels 0..F-1 and sigma in F..2F-1;
// q/tq/tz [N, F] out
SVBFM_EXPORT int svbfm_vb_build_qt(const float* ptab, int64_t ld, int F,
                                   const int* ids, const float* vals,
                                   int64_t N, int P, float* q, float* tq,
                                   float* tz, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((N * F + threads - 1) / threads);
  build_qt_kernel<false><<<blocks, threads, 0, stream>>>(ptab, ld, F, ids,
                                                         vals, N, P, q, tq, tz);
  return static_cast<int>(cudaGetLastError());
}

// X8d: q [N, F] alone from channels 0..F-1 of ptab [D, ld]
SVBFM_EXPORT int svbfm_build_q(const float* ptab, int64_t ld, int F,
                               const int* ids, const float* vals, int64_t N,
                               int P, float* q, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((N * F + threads - 1) / threads);
  build_qt_kernel<true><<<blocks, threads, 0, stream>>>(
      ptab, ld, F, ids, vals, N, P, q, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// One [C, L] bucket.  Writes mu_t/sig_t [D, F] and mu_w/sig_w [D] in place
// at the bucket's columns, and ptab's delta channels; nans[0] += v
// candidates that were not finite, nans[1] += w ones.  mu_w == nullptr
// turns the w rider off (then sx2, sig_w and sigma_w are not read).
SVBFM_EXPORT int svbfm_vb_col_stats_update(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* sx2, const float* e, const float* q,
    const float* tq, int F, float* ptab, int CH, float* mu_t, float* sig_t,
    const float* sv, const float* alpha, float* mu_w, float* sig_w,
    const float* sigma_w, int* nans, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>((F + 31) / 32));
  const dim3 block(32, kStatRows);
  col_stats_kernel<<<grid, block, 0, stream>>>(
      rows, x, L, cols, group, sx2, e, q, tq, F, ptab, CH, mu_t, sig_t, sv,
      alpha, mu_w, sig_w, sigma_w, nans);
  return static_cast<int>(cudaGetLastError());
}

// Patch q/tq/tz [N, F] and e/t [N] in place from ptab [D, CH]; seq
// selects the batch-VB (1) or online-VB (0) position order; a thread per
// row at F = 1, a warp per row at F >= 2.  The w patch (F = 0) has its own
// launch below, a thread per row.
SVBFM_EXPORT int svbfm_vb_patch_rows(const float* ptab, int CH, int F,
                                     int merge_w, int seq, const int* ids,
                                     const float* vals, int64_t N, int P,
                                     float* q, float* tq, float* tz, float* e,
                                     float* t, cudaStream_t stream) {
  if (F == 1) {
    const unsigned blocks =
        static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
    if (seq) {
      patch_rows_kernel<true, 1><<<blocks, kPatchThreads, 0, stream>>>(
          ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
    } else {
      patch_rows_kernel<false, 1><<<blocks, kPatchThreads, 0, stream>>>(
          ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t rows = kPatchThreads / 32;
  const unsigned blocks = static_cast<unsigned>((N + rows - 1) / rows);
  if (seq) {
    patch_rows_kernel<true, 32><<<blocks, kPatchThreads, 0, stream>>>(
        ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
  } else {
    patch_rows_kernel<false, 32><<<blocks, kPatchThreads, 0, stream>>>(
        ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// The w patch of the standalone linear-term sweep: K4 at F = 0, one thread
// per row, its table dtab [D, 2] being the two w channels (mu_old - mu_new,
// sig_new - sig_old); e/t [N] += sum_p x dtab[id, 0], sum_p x^2 dtab[id, 1].
// MCMC's w sweep passes t == nullptr and dtab[:, 0] = w_new - w_old (its
// e = yhat - y has the opposite sign of VB's).
SVBFM_EXPORT int svbfm_w_patch_rows(const float* dtab, const int* ids,
                                    const float* vals, int64_t N, int P,
                                    float* e, float* t, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
  patch_rows_kernel<true, 1><<<blocks, kPatchThreads, 0, stream>>>(
      dtab, 2, 0, 1, ids, vals, N, P, nullptr, nullptr, nullptr, e, t);
  return static_cast<int>(cudaGetLastError());
}
