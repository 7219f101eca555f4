// K6: online VB v column statistics + the natural-gradient blend, one
// [C, L] degree bucket of one factor block.
//
// Replaces the per-bucket body of svbfm_tpu/learners/vb_online.py:
// ovb_v_block (vb_online.py:512-559) and its F = 1 flat form ovb_v_factor
// (:598, same math):
//   h  = q - x mu_old,  h1 = tq - x^2 sig_old           (per entry, factor)
//   v_mean = sum x h (e + x mu_old h) / max(cnt, 1)
//   v_sig  = sum x^2 h h + x^2 h1     / max(cnt, 1)
//   eta2 <- (1 - rho) eta2 + rho (sigma_v(g) + alpha col_count v_sig)
//   eta1 <- (1 - rho) eta1 + rho col_count alpha v_mean
//   mu = eta1 / eta2, sig = 1 / eta2, each kept at its old value where not
//   finite (the naturals are written as they are); a column with cnt == 0
//   keeps all four tables and gets zero deltas.
// rho is the per-column Robbins-Monro rate read before the chunk; the
// pre-bin mu/sig come from the bin's patch table, as in K3, so every bucket
// of a bin reads the values from before the bin.
//
// Layouts: row caches q/tq [N, F] row-major; mu/sig/eta1/eta2 tables
// [D, F]; sigma_v [G, F]; the patch table ptab [D, 5F] with channels
// (mu_old, sig_old, dmu, dsig, dmu2), which K4 then reads.
//
// Bound: memory latency of the random row-cache gathers (e, and F floats of
// q and tq per entry).  Online VB runs one factor at a time (F = 1), where
// K3's layout (32 factor lanes per column) would leave 31 of 32 lanes idle;
// here the block is FL x LY threads with FL = the factor lanes rounded up to
// a power of two (1 at F = 1) and LY entry lanes, so at F = 1 a whole warp
// strides over one column's entries.  A tree sum in shared memory closes
// the entry axis.
#include "svbfm_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void ovb_col_stats_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ cnt, const float* __restrict__ col_count,
    const float* __restrict__ e, const float* __restrict__ q,
    const float* __restrict__ tq, int F, float* __restrict__ ptab,
    float* __restrict__ mu_t, float* __restrict__ sig_t,
    float* __restrict__ nmu_t, float* __restrict__ nsig_t,
    const float* __restrict__ sv, const float* __restrict__ alpha_p,
    const float* __restrict__ rho_v, float* __restrict__ tv_add,
    int* __restrict__ bad) {
  extern __shared__ float s_red[];  // [2][LY][FL]
  const int FL = blockDim.x;
  const int LY = blockDim.y;
  const int c = blockIdx.x;
  const int fx = threadIdx.x;
  const int ly = threadIdx.y;
  const int f = blockIdx.y * FL + fx;
  const bool on = f < F;
  const int64_t col = cols[c];
  float* prow = ptab + col * 5 * F;
  float mu_c = 0.f, sig_c = 0.f;
  if (on) {
    mu_c = prow[f];
    sig_c = prow[F + f];
  }
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  float vm = 0.f, vs = 0.f;
  if (on) {
    for (int l = ly; l < L; l += LY) {
      const int64_t r = crow[l];
      const float xv = cx[l];
      const float x2 = xv * xv;
      const float h = q[r * F + f] - xv * mu_c;
      const float h1 = tq[r * F + f] - x2 * sig_c;
      vm += xv * h * (e[r] + xv * mu_c * h);
      vs += x2 * h * h + x2 * h1;
    }
  }
  float* s_vm = s_red;
  float* s_vs = s_red + LY * FL;
  s_vm[ly * FL + fx] = vm;
  s_vs[ly * FL + fx] = vs;
  __syncthreads();
  for (int half = LY / 2; half > 0; half >>= 1) {
    if (ly < half) {
      s_vm[ly * FL + fx] += s_vm[(ly + half) * FL + fx];
      s_vs[ly * FL + fx] += s_vs[(ly + half) * FL + fx];
    }
    __syncthreads();
  }
  if (ly != 0 || !on) return;  // no barrier follows
  const float n = cnt[c];
  const int64_t o = col * F + f;
  if (!(n > 0.f)) {
    prow[2 * F + f] = 0.f;
    prow[3 * F + f] = 0.f;
    prow[4 * F + f] = 0.f;
    return;
  }
  const float cnt1 = fmaxf(n, 1.f);
  const float v_mean = s_vm[fx] / cnt1;
  const float v_sig = s_vs[fx] / cnt1;
  const float alpha = *alpha_p;
  const float rho = rho_v[col];
  const float cc = col_count[c];
  const float nsig_new =
      (1.f - rho) * nsig_t[o] + rho * (sv[group[c] * F + f] + alpha * cc * v_sig);
  const float nmu_new = (1.f - rho) * nmu_t[o] + rho * cc * alpha * v_mean;
  const float mu_cand = nmu_new / nsig_new;
  const float sig_cand = 1.f / nsig_new;
  const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
  const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
  mu_t[o] = mu_new;
  sig_t[o] = sig_new;
  nmu_t[o] = nmu_new;
  nsig_t[o] = nsig_new;
  prow[2 * F + f] = mu_new - mu_c;
  prow[3 * F + f] = sig_new - sig_c;
  prow[4 * F + f] = mu_new * mu_new - mu_c * mu_c;
  if (f == 0) tv_add[col] += n;
  if (isnan(mu_cand)) atomicAdd(&bad[0], 1);
  if (isinf(mu_cand)) atomicAdd(&bad[1], 1);
  if (isnan(sig_cand)) atomicAdd(&bad[2], 1);
  if (isinf(sig_cand)) atomicAdd(&bad[3], 1);
}

inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

// One [C, L] bucket of an F-factor block.  Writes mu/sig/nmu/nsig [D, F] in
// place at the bucket's columns, ptab's delta channels, tv_add[col] += cnt,
// and bad[4] += (nan mu, inf mu, nan sig, inf sig) candidates.
SVBFM_EXPORT int svbfm_ovb_col_stats_update(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* cnt, const float* col_count,
    const float* e, const float* q, const float* tq, int F, float* ptab,
    float* mu_t, float* sig_t, float* nmu_t, float* nsig_t, const float* sv,
    const float* alpha, const float* rho_v, float* tv_add, int* bad,
    cudaStream_t stream) {
  const int FL = pow2_at_least(F < 32 ? F : 32);
  int LY = pow2_at_least(L);
  if (LY * FL < 32) LY = 32 / FL;
  if (LY * FL > kMaxThreads) LY = kMaxThreads / FL;
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>((F + FL - 1) / FL));
  const dim3 block(FL, LY);
  const size_t shared = 2 * sizeof(float) * FL * LY;
  ovb_col_stats_kernel<<<grid, block, shared, stream>>>(
      rows, x, L, cols, group, cnt, col_count, e, q, tq, F, ptab, mu_t, sig_t,
      nmu_t, nsig_t, sv, alpha, rho_v, tv_add, bad);
  return static_cast<int>(cudaGetLastError());
}
