// K5: the standalone linear-term column sweep, batch VB (exact mode, K = 0)
// and online VB; X8c, the w draw of Gibbs MCMC and ALS; and K5's gradient
// mode, the w column step of the full-batch exp_sgd (X9d).
//
// Replaces svbfm_tpu/learners/vb.py:vb_w_bin_update (vb.py:125-148) and its
// OVB twin vb_online.py:230-269: per [C, L] degree bucket, the column
// statistic sxe = sum x e (OVB: sum x (e + x mu) / max(cnt, 1)) and the
// closed-form update (VB) or the natural-gradient blend (OVB), written in
// place at the bucket's columns with the [D, 2] delta table
// (mu_old - mu_new, sig_new - sig_old).  The w patch of the row caches from
// that table (vb.py:149-157, vb_online.py:270-282) is K4 at F = 0
// (svbfm_w_patch_rows in vb_sweep.cu).
//
// The MCMC mode (svbfm_mcmc_w_draw) replaces the bucket body of
// svbfm_tpu/learners/mcmc.py:w_sweep_main (mcmc.py:632-652): the same
// gather and sum sxe = sum x e (MCMC's e = yhat - y), then the conditional
// draw w ~ N(-s2 (alpha (sxe - w sx2) - mu_g lambda_g), s2),
// s2 = 1 / (lambda_g + alpha sx2), with the z table's number for the column
// (none for ALS); a bad s2 gives 0 uncounted, a bad draw is counted and
// reverted.  Its delta table is (w_new - w_old, 0), which the same w patch
// adds to e with t == nullptr.
//
// The gradient mode (svbfm_w_grad_step) replaces the bucket body of the w
// bins of svbfm_tpu/learners/exp_sgd.py:exp_sgd_sweep (:77-87): the same
// sum sxe = sum x e, with e = stdev yhat - y, then the coordinate step
// w' = keep_finite(w - lr (sxe + regw w) / N, w).  Its delta table is
// (w_new - w_old, 0) as in the MCMC mode, so the w patch adds
// sum x (w_new - w_old) to e: exp_sgd.py:88-91's e -= sum x (w_old - w_new).
//
// Layouts: bucket rows/x [C, L] row-major, the JAX layout; parameter and
// natural tables [D]; the delta table dtab [D, 2] row-major, K4's patch
// table at F = 0 (its two w channels).
//
// Bound: memory latency of the random e[row] gathers (one float per entry
// at a data-dependent address); the arithmetic is a few FLOPs per float
// read.  Each column gets one warp, lanes strided over its entries and a
// shuffle sum, so a bucket of short columns (L = 8 at an OVB chunk) still
// keeps whole warps busy.
#include "svbfm_common.cuh"

namespace {

constexpr int kColsPerBlock = 8;  // one warp per column

// One column per warp.  mode 0: closed form (vb.py:141-148), counts of
// the raw candidates.  mode 1: the natural-gradient blend with rate
// rho[col] (vb_online.py:245-269); a column with cnt == 0 keeps every
// table and gets zero deltas; counts of where(active, cand, 0).  The
// primal falls back to the old value where its candidate is not finite;
// the naturals are written as they are.  bad[4] += (nan mu, inf mu,
// nan sig, inf sig) candidates.  mode 2: the MCMC draw (see the top);
// mu_w is w, sigma_w the group lambdas, prior_mu the group means, z the
// [D] noise table or nullptr; bad[0], bad[1] += nan, inf draws.
// mode 3: the exp_sgd gradient step (see the top); mu_w is w, and lr, reg,
// n_cases its step size, regw and N.
constexpr int kModeVB = 0, kModeOVB = 1, kModeMCMC = 2, kModeGrad = 3;

__global__ void w_col_update_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ sx2, const float* __restrict__ e,
    float* __restrict__ mu_w, float* __restrict__ sig_w,
    const float* __restrict__ sigma_w, const float* __restrict__ alpha_p,
    float* __restrict__ dtab, int* __restrict__ bad, int mode,
    const float* __restrict__ cnt, const float* __restrict__ col_count,
    float* __restrict__ nmu_w, float* __restrict__ nsig_w,
    const float* __restrict__ rho_w, float* __restrict__ t_wj,
    const float* __restrict__ prior_mu, const float* __restrict__ z,
    float lr, float reg, float n_cases) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp leaves together
  const int64_t col = cols[c];
  const float mu_c = mu_w[col];
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  float s = 0.f;
  for (int l = lane; l < L; l += 32) {
    const float xv = cx[l];
    const float ev = e[crow[l]];
    s += mode == kModeOVB ? xv * (ev + xv * mu_c) : xv * ev;
  }
  s = svbfm::warp_sum(s);
  if (lane != 0) return;
  if (mode == kModeGrad) {  // exp_sgd.py:84-87
    float w_new = mu_c - lr * (s + reg * mu_c) / n_cases;
    if (!isfinite(w_new)) w_new = mu_c;
    mu_w[col] = w_new;
    dtab[2 * col] = w_new - mu_c;
    dtab[2 * col + 1] = 0.f;
    return;
  }
  const float alpha = *alpha_p;
  const float sw = sigma_w[group[c]];
  const float sxx = sx2[c];
  if (mode == kModeMCMC) {  // mcmc.py:641-652
    const float s2 = 1.f / (sw + alpha * sxx);
    const float mean = -s2 * (alpha * (s - mu_c * sxx) - prior_mu[group[c]] * sw);
    float val = z != nullptr ? mean + sqrtf(s2) * z[col] : mean;
    if (!isfinite(s2)) val = 0.f;  // uncounted, as the reference
    if (isnan(val)) atomicAdd(&bad[0], 1);
    if (isinf(val)) atomicAdd(&bad[1], 1);
    const float w_new = isfinite(val) ? val : mu_c;
    mu_w[col] = w_new;
    dtab[2 * col] = w_new - mu_c;
    dtab[2 * col + 1] = 0.f;
    return;
  }
  const float sig_c = sig_w[col];
  float mu_cand, sig_cand, mu_new, sig_new;
  if (mode == kModeVB) {
    sig_cand = 1.f / (sw + alpha * sxx);
    sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    mu_cand = sig_new * alpha * (s + mu_c * sxx);
    mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
  } else {
    const float n = cnt[c];
    if (!(n > 0.f)) {
      dtab[2 * col] = 0.f;
      dtab[2 * col + 1] = 0.f;
      return;
    }
    const float cnt1 = fmaxf(n, 1.f);
    const float rho = rho_w[col];
    const float cc = col_count[c];
    const float nsig_new =
        (1.f - rho) * nsig_w[col] + rho * (sw + alpha * cc * (sxx / cnt1));
    const float nmu_new = (1.f - rho) * nmu_w[col] + rho * cc * alpha * (s / cnt1);
    mu_cand = nmu_new / nsig_new;
    sig_cand = 1.f / nsig_new;
    mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    nmu_w[col] = nmu_new;
    nsig_w[col] = nsig_new;
    t_wj[col] += n;
  }
  mu_w[col] = mu_new;
  sig_w[col] = sig_new;
  dtab[2 * col] = mu_c - mu_new;
  dtab[2 * col + 1] = sig_new - sig_c;
  if (isnan(mu_cand)) atomicAdd(&bad[0], 1);
  if (isinf(mu_cand)) atomicAdd(&bad[1], 1);
  if (isnan(sig_cand)) atomicAdd(&bad[2], 1);
  if (isinf(sig_cand)) atomicAdd(&bad[3], 1);
}

}  // namespace

// One [C, L] bucket.  Writes mu_w/sig_w [D] and dtab [D, 2] at the
// bucket's columns; with ovb != 0 also nmu_w/nsig_w [D] and t_wj [D]
// (+= cnt), reading cnt/col_count [C] and the rate table rho_w [D] (those
// five pointers are not read when ovb == 0).
SVBFM_EXPORT int svbfm_w_col_update(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* sx2, const float* e, float* mu_w,
    float* sig_w, const float* sigma_w, const float* alpha, float* dtab,
    int* bad, int ovb, const float* cnt, const float* col_count, float* nmu_w,
    float* nsig_w, const float* rho_w, float* t_wj, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((C + kColsPerBlock - 1) / kColsPerBlock);
  w_col_update_kernel<<<blocks, 32 * kColsPerBlock, 0, stream>>>(
      rows, x, C, L, cols, group, sx2, e, mu_w, sig_w, sigma_w, alpha, dtab,
      bad, ovb ? kModeOVB : kModeVB, cnt, col_count, nmu_w, nsig_w, rho_w,
      t_wj, nullptr, nullptr, 0.f, 0.f, 1.f);
  return static_cast<int>(cudaGetLastError());
}

// X8c, one [C, L] bucket of the MCMC/ALS w sweep.  Writes w [D] and dtab
// [D, 2] at the bucket's columns; w_mu/w_lambda [G] are the group priors,
// z the [D] noise table (nullptr: ALS, the mean); bad[0], bad[1] += the
// nan, inf draws.
SVBFM_EXPORT int svbfm_mcmc_w_draw(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* sx2, const float* e, float* w,
    const float* w_mu, const float* w_lambda, const float* alpha,
    const float* z, float* dtab, int* bad, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((C + kColsPerBlock - 1) / kColsPerBlock);
  w_col_update_kernel<<<blocks, 32 * kColsPerBlock, 0, stream>>>(
      rows, x, C, L, cols, group, sx2, e, w, nullptr, w_lambda, alpha, dtab,
      bad, kModeMCMC, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      w_mu, z, 0.f, 0.f, 1.f);
  return static_cast<int>(cudaGetLastError());
}

// K5's gradient mode (X9d), one [C, L] bucket of the exp_sgd w sweep.
// Writes w [D] and dtab [D, 2] = (w_new - w_old, 0) at the bucket's columns.
SVBFM_EXPORT int svbfm_w_grad_step(const int* rows, const float* x, int C,
                                   int L, const int* cols, const float* e,
                                   float* w, float* dtab, float lr, float reg,
                                   float n_cases, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((C + kColsPerBlock - 1) / kColsPerBlock);
  w_col_update_kernel<<<blocks, 32 * kColsPerBlock, 0, stream>>>(
      rows, x, C, L, cols, nullptr, nullptr, e, w, nullptr, nullptr, nullptr,
      dtab, nullptr, kModeGrad, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, lr, reg, n_cases);
  return static_cast<int>(cudaGetLastError());
}
