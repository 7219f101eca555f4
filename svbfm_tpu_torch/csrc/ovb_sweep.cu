// K6: online VB v column statistics + the natural-gradient blend, every
// [C, L] degree bucket of one bin of one factor block in one launch.
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
// of a bin reads the values from before the bin, and a bin's buckets can
// run in one launch (a column sits in one bucket of one bin).
//
// Layouts: row caches q/tq [N, F] row-major; mu/sig/eta1/eta2 tables
// [D, F]; sigma_v [G, F]; the patch table ptab [D, 5F] with channels
// (mu_old, sig_old, dmu, dsig, dmu2), which K4 then reads.  The bin's plan
// table, int64 [nb, kPlanCols], a row a bucket: rows, x, cols, group, cnt
// and col_count pointers, C and L (mirrored by
// kernels/ovb_sweep.py:BinPlan, which the learner builds once per chunk
// membership).
//
// Bound: memory latency of the random row-cache gathers (e, and F floats of
// q and tq per entry): an OVB chunk's bin holds ~25k entries, a few
// hundred kB of gathers, a fraction of a microsecond at HBM rate; the
// launch and the dependent global reads (the plan, the column's id and
// rows, then its gathers) set the time.
// Design: U lanes a column, U = FL S at most 32 with FL factor lanes (the
// next power of two >= F, at most 32; F > 32 loops over chunks of 32
// factors) and S entry slots (the next power of two >= L, up to 32 / FL),
// so at F = 1 a bucket of L = 16 takes 16 lanes a column and two columns a
// warp, not a block of 32 threads a column.  The blocks of the bin's
// buckets are laid end to end, each ceil(C U / 256) blocks; a warp finds
// its block's bucket from the plan's C and L, 32 buckets a read
// (find_bucket).  A column's ending-step operands (ptab's old mu/sig,
// eta1, eta2, sigma_v, rho, cnt, col_count) are loaded before its entry
// loop, so their latency overlaps the gathers; the slots' sums close with
// a butterfly of __shfl_xor_sync in a fixed order: no shared memory, no
// barrier, and two launches give the same bits.  Padding entries (x = 0)
// are summed as the twin sums them.
#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanCols = 8;

struct Bucket {
  const int* rows;        // [C, L]
  const float* x;         // [C, L]
  const int* cols;        // [C]
  const int* group;       // [C]
  const float* cnt;       // [C]
  const float* col_count; // [C]
  int C, L;
};

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// FL, the factor lanes of a column (mirrored by
// kernels/ovb_sweep.py:col_lanes)
__host__ __device__ inline int factor_lanes(int F) {
  return pow2_at_least(F < 32 ? F : 32);
}

// U, the lanes of a column of a bucket of L slots
__host__ __device__ inline int col_lanes(int F, int L) {
  const int u = factor_lanes(F) * pow2_at_least(L < 32 ? (L > 0 ? L : 1) : 32);
  return u < 32 ? u : 32;
}

__host__ __device__ inline int64_t bucket_blocks(int C, int F, int L) {
  return (static_cast<int64_t>(C) * col_lanes(F, L) + kThreads - 1) /
         kThreads;
}

// The bucket whose blocks hold this block, and its first block, found by
// each warp on its own: the lanes read 32 buckets' rows of the plan at
// once, sum their blocks by shuffles (an inclusive prefix), and a ballot
// picks the first bucket that ends past this block (an empty bucket ends
// where the one before it does, so it is never picked).  The whole warp
// takes part.
__device__ inline Bucket find_bucket(const int64_t* __restrict__ plan,
                                     int nb, int F, int64_t& first) {
  const int lane = threadIdx.x & 31;
  first = 0;
  for (int base = 0; base < nb; base += 32) {
    const int b = base + lane;
    int64_t p[kPlanCols];
#pragma unroll
    for (int k = 0; k < kPlanCols; ++k)
      p[k] = b < nb ? plan[b * kPlanCols + k] : 0;
    const int64_t nblk =
        b < nb ? bucket_blocks(static_cast<int>(p[6]), F,
                               static_cast<int>(p[7]))
               : 0;
    int64_t end = nblk;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t v = __shfl_up_sync(svbfm::kFullMask, end, o);
      if (lane >= o) end += v;
    }
    const unsigned hit =
        __ballot_sync(svbfm::kFullMask, b < nb && blockIdx.x < first + end);
    if (hit != 0) {
      const int src = __ffs(hit) - 1;
      first += __shfl_sync(svbfm::kFullMask, end - nblk, src);
#pragma unroll
      for (int k = 0; k < kPlanCols; ++k)
        p[k] = __shfl_sync(svbfm::kFullMask, p[k], src);
      return Bucket{reinterpret_cast<const int*>(p[0]),
                    reinterpret_cast<const float*>(p[1]),
                    reinterpret_cast<const int*>(p[2]),
                    reinterpret_cast<const int*>(p[3]),
                    reinterpret_cast<const float*>(p[4]),
                    reinterpret_cast<const float*>(p[5]),
                    static_cast<int>(p[6]), static_cast<int>(p[7])};
    }
    first += __shfl_sync(svbfm::kFullMask, end, 31);
  }
  return Bucket{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1};
}

__global__ void __launch_bounds__(kThreads) ovb_col_stats_kernel(
    const int64_t* __restrict__ plan, int nb, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ tq, int F,
    float* __restrict__ ptab, float* __restrict__ mu_t,
    float* __restrict__ sig_t, float* __restrict__ nmu_t,
    float* __restrict__ nsig_t, const float* __restrict__ sv,
    const float* __restrict__ alpha_p, const float* __restrict__ rho_v,
    float* __restrict__ tv_add, int* __restrict__ bad) {
  int64_t first;
  const Bucket bk = find_bucket(plan, nb, F, first);
  const int L = bk.L;
  // U and FL are powers of two: shifts, not divisions
  const int u_shift = __ffs(col_lanes(F, L)) - 1;
  const int fl_shift = __ffs(factor_lanes(F)) - 1;
  const int U = 1 << u_shift;
  const int FL = 1 << fl_shift;
  const int S = U >> fl_shift;
  const int64_t c =
      ((blockIdx.x - first) * kThreads + threadIdx.x) >> u_shift;
  const int lane = threadIdx.x & (U - 1);
  const int fx = lane & (FL - 1);
  const int sl = lane >> fl_shift;
  const bool live = c < bk.C;
  const bool has0 = live && sl < L;  // the lane has an entry
  const float alpha = *alpha_p;
  // the column's id and the lane's first entry are read together, then
  // what they address (the column's operands, the entry's gathers), so
  // that the reads wait twice, not four times
  int64_t col = 0, r0 = 0;
  float n = 0.f, cc = 0.f, x0 = 0.f;
  int g = 0;
  const int* __restrict__ crow = bk.rows + c * L;
  const float* __restrict__ cx = bk.x + c * L;
  if (live) {
    col = bk.cols[c];
    n = bk.cnt[c];
    cc = bk.col_count[c];
    g = bk.group[c];
  }
  if (has0) {
    r0 = crow[sl];
    x0 = cx[sl];
  }
  float rho = 0.f, tva = 0.f;
  if (live) {
    rho = rho_v[col];
    tva = tv_add[col];
  }
  const float e0 = has0 ? e[r0] : 0.f;
  float* prow = ptab + col * 5 * F;
  // every lane runs the same factor chunks, so the shuffles see the whole
  // warp
  for (int f0 = 0; f0 < F; f0 += FL) {
    const int f = f0 + fx;
    const bool on = live && f < F;
    const int64_t o = col * F + f;
    float mu_c = 0.f, sig_c = 0.f, nmu = 0.f, nsig = 0.f, svf = 0.f;
    float q0 = 0.f, tq0 = 0.f;
    if (on) {
      mu_c = prow[f];
      sig_c = prow[F + f];
      nmu = nmu_t[o];
      nsig = nsig_t[o];
      svf = sv[g * F + f];
      if (has0) {
        q0 = q[r0 * F + f];
        tq0 = tq[r0 * F + f];
      }
    }
    float vm = 0.f, vs = 0.f;
    if (on && has0) {
      const float x2 = x0 * x0;
      const float h = q0 - x0 * mu_c;
      const float h1 = tq0 - x2 * sig_c;
      vm += x0 * h * (e0 + x0 * mu_c * h);
      vs += x2 * h * h + x2 * h1;
#pragma unroll 4
      for (int l = sl + S; l < L; l += S) {
        const int64_t r = crow[l];
        const float xv = cx[l];
        const float x2 = xv * xv;
        const float h = q[r * F + f] - xv * mu_c;
        const float h1 = tq[r * F + f] - x2 * sig_c;
        vm += xv * h * (e[r] + xv * mu_c * h);
        vs += x2 * h * h + x2 * h1;
      }
    }
    for (int m = U >> 1; m >= FL; m >>= 1) {
      vm += __shfl_xor_sync(svbfm::kFullMask, vm, m);
      vs += __shfl_xor_sync(svbfm::kFullMask, vs, m);
    }
    if (!on || sl != 0) continue;
    if (!(n > 0.f)) {
      prow[2 * F + f] = 0.f;
      prow[3 * F + f] = 0.f;
      prow[4 * F + f] = 0.f;
      continue;
    }
    const float cnt1 = fmaxf(n, 1.f);
    const float v_mean = vm / cnt1;
    const float v_sig = vs / cnt1;
    const float nsig_new =
        (1.f - rho) * nsig + rho * (svf + alpha * cc * v_sig);
    const float nmu_new = (1.f - rho) * nmu + rho * cc * alpha * v_mean;
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
    if (f == 0) tv_add[col] = tva + n;  // a column sits in one bucket
    if (isnan(mu_cand)) atomicAdd(&bad[0], 1);
    if (isinf(mu_cand)) atomicAdd(&bad[1], 1);
    if (isnan(sig_cand)) atomicAdd(&bad[2], 1);
    if (isinf(sig_cand)) atomicAdd(&bad[3], 1);
  }
}

}  // namespace

// Every bucket of one bin (plan: nb rows of kPlanCols, `blocks` the sum of
// their bucket_blocks at F, from the wrapper) of an F-factor block.
// Writes mu/sig/nmu/nsig [D, F] in place at the bin's columns, ptab's delta
// channels, tv_add[col] += cnt, and bad[4] += (nan mu, inf mu, nan sig,
// inf sig) candidates.
SVBFM_EXPORT int svbfm_ovb_col_stats_update(
    const int64_t* plan, int nb, int64_t blocks, const float* e,
    const float* q, const float* tq, int F, float* ptab, float* mu_t,
    float* sig_t, float* nmu_t, float* nsig_t, const float* sv,
    const float* alpha, const float* rho_v, float* tv_add, int* bad,
    cudaStream_t stream) {
  if (blocks == 0) return 0;
  ovb_col_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(plan, nb, e, q, tq, F, ptab, mu_t, sig_t,
                                   nmu_t, nsig_t, sv, alpha, rho_v, tv_add,
                                   bad);
  return static_cast<int>(cudaGetLastError());
}
