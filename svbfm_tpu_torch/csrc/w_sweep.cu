// K5: the standalone linear-term column sweep, batch VB (exact mode, K = 0)
// and online VB; X8c, the w draw of Gibbs MCMC and ALS; and K5's gradient
// mode, the w column step of the full-batch exp_sgd (X9d).  Every degree
// bucket of one conflict-free bin in one launch.  T3 at K = 0, the
// feature-sharded w sweep's stats and update launches, T5, its Gibbs/ALS
// draw, and T10, its online-VB stats and blend, are at the end.
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
// table at F = 0 (its two w channels).  The bin's plan, int64 [nb,
// kPlanCols] in host memory, a row a bucket: rows, x, cols, group, sx2,
// cnt and col_count pointers, C, L and the bucket's first block (mirrored
// by kernels/w_sweep.py:w_plan_rows; a mode reads only the pointers it
// needs), at most kMaxBuckets rows a launch.
//
// Bound: the random e[row] gathers, a float a slot at a data-dependent
// address, each its own 32-byte sector of the [N] residual that L2 holds,
// beside the rows and x streamed once: the card's rate of L2 sectors, not
// HBM bytes; a few FLOPs a gather.  Design: a column sits in exactly one
// bucket of one bin and every bucket reads e from before the bin, so the
// bin's buckets go in one launch, their blocks laid end to end.  The plan
// is a kernel parameter: a block finds its bucket in the parameter bank,
// with no global load ahead of its own (a device table cost two dependent
// reads a block, 3 % on the [6026,256] bucket).  A bucket of L slots
// gives a column U lanes, U = the next power of two >= L, at most 32
// (K6's col_lanes at F = 1): 256 / U columns a block, so an OVB chunk's
// L = 8 bucket keeps four columns a warp.  Lane li sums slots li, li + U,
// ..., a plain strided loop: on the H100 the long buckets are held by L2
// sectors, so 16-byte loads of rows and x and rounds of 8 slots with
// every gather issued first gained nothing over it.  Where U = 32 the
// stride is a constant of the build, so ptxas unrolls the loop and keeps
// several gathers in flight (a stride read at run time cost 5-25 % on the
// long buckets).  The column's closing operands are loaded before the
// loop, so that their latency overlaps the gathers (after the sum, an
// OVB bin took 10 % longer).  The lanes close with a butterfly of
// __shfl_xor_sync in a fixed order: no shared memory, and two launches
// give the same bits.  The mode is a template parameter: one body, six
// builds.
//
// X13b, the window-accumulating mode (kVBWin, the out-of-core batch VB of
// svbfm_tpu/learners/vb_windowed.py:550-599): the bin's buckets are one
// window's [C, L] views of global column buckets, their rows local to the
// window, and e the window's rows of the resident residual (a base pointer
// at the window's first row).  The column's head lane adds its window sum
// sum x e to the [D] accumulator acc at the column in window order (the
// first window writes it, later ones add to it: JAX's a + q at :768);
// only the last window's launch applies batch VB's closed form to the
// accumulated sum with the bucket's GLOBAL sx2 and writes w, the delta
// table and the counts, as mode VB does.  One lane writes each column.
//
// X14b (kMCMCWin, the out-of-core Gibbs/ALS of
// svbfm_tpu/learners/mcmc_windowed.py:246-292, make_wstats + make_wdraw)
// is the same window accumulator with mode MCMC's draw at the last
// window: the GLOBAL sx2, the z table's number for the column, the delta
// table (w_new - w_old, 0) and the NaN/Inf draw counts.  The window kernel
// is a template on the two window modes.
#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanCols = 10;
constexpr int kMaxBuckets = 32;  // buckets a launch

// mode VB: the closed form (vb.py:141-148), counts of the raw candidates.
// OVB: the natural-gradient blend with rate rho_w[col]
// (vb_online.py:245-269); a column with cnt == 0 keeps every table and
// gets zero deltas; counts of where(active, cand, 0).  The primal falls
// back to the old value where its candidate is not finite; the naturals
// are written as they are.  bad[4] += (nan mu, inf mu, nan sig, inf sig)
// candidates.  MCMC: the draw (see the top); mu_w is w, sigma_w the group
// lambdas, prior_mu the group means, z the [D] noise table or nullptr;
// bad[0], bad[1] += nan, inf draws.  Grad: the exp_sgd step (see the top);
// mu_w is w, and lr, reg, n_cases its step size, regw and N.
enum Mode { kVB, kOVB, kMCMC, kGrad, kVBWin, kMCMCWin };

struct Bucket {
  const int* rows;         // [C, L]
  const float* x;          // [C, L]
  const int* cols;         // [C]
  const int* group;        // [C]
  const float* sx2;        // [C]
  const float* cnt;        // [C]
  const float* col_count;  // [C]
  int C, L;
  int64_t first;  // the bucket's first block
};

// The bin's tables, the same for every bucket.
struct WArgs {
  const float* e;         // [N]
  float* mu_w;            // [D] (w in the MCMC and gradient modes)
  float* sig_w;           // [D]
  const float* sigma_w;   // [G] group precisions, or MCMC's lambdas
  const float* prior_mu;  // [G] MCMC's group means
  const float* alpha;     // device scalar
  const float* z;         // [D] MCMC's noise, or nullptr
  float* nmu_w;           // [D] OVB's naturals, rate and counts
  float* nsig_w;
  const float* rho_w;
  float* t_wj;
  float* dtab;  // [D, 2]
  int* bad;     // [4]
  float lr, reg, n_cases;
};

// U, the lanes of a column of a bucket of L slots (mirrored by
// kernels/w_sweep.py:col_lanes)
__host__ __device__ inline int col_lanes(int L) {
  int u = 1;
  while (u < L && u < 32) u <<= 1;
  return u;
}

// X13b's accumulator and the window's place: bit 0 of win marks the first
// window, bit 1 the last.
struct WinArgs {
  float* acc;  // [D]
  int win;
};

// The plan of a launch, passed by value: the kernel reads it from the
// parameter bank, so a block finds its bucket without a global load.
struct Plan {
  Bucket b[kMaxBuckets];
  int nb;
};

// Column c of bucket bk on its U lanes (li the lane's place among them),
// kU = U where the build fixes it, else 0.  The plan's arrays are read
// through __ldg: nothing tells the compiler that the plan's pointers are
// global, so it would read them with generic loads.  Every lane of the
// warp reaches the butterfly.
template <int kMode, int kU>
__device__ __forceinline__ void column(const Bucket& bk, int64_t c, int li,
                                       int U, const WArgs& a,
                                       const WinArgs& wa = WinArgs{}) {
  const int stride = kU ? kU : U;
  const bool live = c < bk.C;
  const bool head = live && li == 0;  // the lane that closes the column
  int64_t col = 0;
  int g = 0;
  float mu_c = 0.f, sig_c = 0.f, sw = 0.f, pm = 0.f, sxx = 0.f, zc = 0.f;
  float alpha = 0.f, n = 0.f, cc = 0.f, rho = 0.f, nmu = 0.f, nsig = 0.f;
  float tw = 0.f, s = 0.f;
  if (live) {
    col = __ldg(bk.cols + c);
    if (head && kMode != kGrad) {
      g = __ldg(bk.group + c);
      sxx = __ldg(bk.sx2 + c);
      alpha = *a.alpha;
      if (kMode == kOVB) {
        n = __ldg(bk.cnt + c);
        cc = __ldg(bk.col_count + c);
      }
    }
    if (kMode == kOVB || head) mu_c = a.mu_w[col];  // OVB: every slot's term
    if (head && kMode != kGrad) {
      sw = a.sigma_w[g];
      if (kMode == kMCMC || kMode == kMCMCWin) {
        pm = a.prior_mu[g];
        if (a.z != nullptr) zc = a.z[col];
      } else {
        sig_c = a.sig_w[col];
      }
      if (kMode == kOVB) {
        rho = a.rho_w[col];
        nmu = a.nmu_w[col];
        nsig = a.nsig_w[col];
        tw = a.t_wj[col];
      }
    }
    const int L = bk.L;
    const int* __restrict__ crow = bk.rows + c * L;
    const float* __restrict__ cx = bk.x + c * L;
    for (int l = li; l < L; l += stride) {
      const float xv = __ldg(cx + l);
      const float ev = __ldg(a.e + __ldg(crow + l));
      s += kMode == kOVB ? xv * (ev + xv * mu_c) : xv * ev;
    }
  }
  for (int o = stride >> 1; o > 0; o >>= 1)
    s += __shfl_xor_sync(svbfm::kFullMask, s, o);
  if (!head) return;
  if (kMode == kVBWin || kMode == kMCMCWin) {
    const float tot = (wa.win & 1) ? s : wa.acc[col] + s;
    if (!(wa.win & 2)) {
      wa.acc[col] = tot;
      return;
    }
    s = tot;
  }
  float* drow = a.dtab + 2 * col;
  if (kMode == kGrad) {  // exp_sgd.py:84-87
    float w_new = mu_c - a.lr * (s + a.reg * mu_c) / a.n_cases;
    if (!isfinite(w_new)) w_new = mu_c;
    a.mu_w[col] = w_new;
    drow[0] = w_new - mu_c;
    drow[1] = 0.f;
    return;
  }
  if (kMode == kMCMC || kMode == kMCMCWin) {  // mcmc.py:641-652
    const float s2 = 1.f / (sw + alpha * sxx);
    const float mean = -s2 * (alpha * (s - mu_c * sxx) - pm * sw);
    float val = a.z != nullptr ? mean + sqrtf(s2) * zc : mean;
    if (!isfinite(s2)) val = 0.f;  // uncounted, as the reference
    if (isnan(val)) atomicAdd(&a.bad[0], 1);
    if (isinf(val)) atomicAdd(&a.bad[1], 1);
    const float w_new = isfinite(val) ? val : mu_c;
    a.mu_w[col] = w_new;
    drow[0] = w_new - mu_c;
    drow[1] = 0.f;
    return;
  }
  float mu_cand, sig_cand, mu_new, sig_new;
  if (kMode == kVB || kMode == kVBWin) {
    sig_cand = 1.f / (sw + alpha * sxx);
    sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    mu_cand = sig_new * alpha * (s + mu_c * sxx);
    mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
  } else {
    if (!(n > 0.f)) {
      drow[0] = 0.f;
      drow[1] = 0.f;
      return;
    }
    const float cnt1 = fmaxf(n, 1.f);
    const float nsig_new =
        (1.f - rho) * nsig + rho * (sw + alpha * cc * (sxx / cnt1));
    const float nmu_new = (1.f - rho) * nmu + rho * cc * alpha * (s / cnt1);
    mu_cand = nmu_new / nsig_new;
    sig_cand = 1.f / nsig_new;
    mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    a.nmu_w[col] = nmu_new;
    a.nsig_w[col] = nsig_new;
    a.t_wj[col] = tw + n;
  }
  a.mu_w[col] = mu_new;
  a.sig_w[col] = sig_new;
  drow[0] = mu_c - mu_new;
  drow[1] = sig_new - sig_c;
  if (isnan(mu_cand)) atomicAdd(&a.bad[0], 1);
  if (isinf(mu_cand)) atomicAdd(&a.bad[1], 1);
  if (isnan(sig_cand)) atomicAdd(&a.bad[2], 1);
  if (isinf(sig_cand)) atomicAdd(&a.bad[3], 1);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    w_bin_kernel(const __grid_constant__ Plan p,
                 const __grid_constant__ WArgs a) {
  // the block's bucket: the last one whose first block is <= blockIdx.x (a
  // bucket with no blocks shares its first block with the next, so it is
  // stepped over); every thread reads the same words of the bank
  int b = 0;
  while (b + 1 < p.nb &&
         p.b[b + 1].first <= static_cast<int64_t>(blockIdx.x))
    ++b;
  const Bucket& bk = p.b[b];
  const int U = col_lanes(bk.L);
  const int64_t c =
      ((static_cast<int64_t>(blockIdx.x) - bk.first) * kThreads +
       threadIdx.x) / U;
  if (U == 32)
    column<kMode, 32>(bk, c, threadIdx.x & 31, U, a);
  else
    column<kMode, 0>(bk, c, threadIdx.x & (U - 1), U, a);
}

// X13b (kVBWin) and X14b (kMCMCWin): the same block-to-bucket walk; mode
// VB's or MCMC's body with the window accumulator.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    w_bin_win_kernel(const __grid_constant__ Plan p,
                     const __grid_constant__ WArgs a,
                     const __grid_constant__ WinArgs wa) {
  int b = 0;
  while (b + 1 < p.nb &&
         p.b[b + 1].first <= static_cast<int64_t>(blockIdx.x))
    ++b;
  const Bucket& bk = p.b[b];
  const int U = col_lanes(bk.L);
  const int64_t c =
      ((static_cast<int64_t>(blockIdx.x) - bk.first) * kThreads +
       threadIdx.x) / U;
  if (U == 32)
    column<kMode, 32>(bk, c, threadIdx.x & 31, U, a, wa);
  else
    column<kMode, 0>(bk, c, threadIdx.x & (U - 1), U, a, wa);
}

Plan make_plan(const int64_t* plan, int nb) {
  Plan p{};
  p.nb = nb;
  for (int i = 0; i < nb; ++i) {
    const int64_t* r = plan + i * kPlanCols;
    p.b[i] = Bucket{reinterpret_cast<const int*>(r[0]),
                    reinterpret_cast<const float*>(r[1]),
                    reinterpret_cast<const int*>(r[2]),
                    reinterpret_cast<const int*>(r[3]),
                    reinterpret_cast<const float*>(r[4]),
                    reinterpret_cast<const float*>(r[5]),
                    reinterpret_cast<const float*>(r[6]),
                    static_cast<int>(r[7]), static_cast<int>(r[8]), r[9]};
  }
  return p;
}

template <int kMode>
int launch(const int64_t* plan, int nb, int64_t blocks, const WArgs& a,
           cudaStream_t stream) {
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  w_bin_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(make_plan(plan, nb), a);
  return static_cast<int>(cudaGetLastError());
}

// The window modes' launch (kVBWin, kMCMCWin).
template <int kMode>
int launch_win(const int64_t* plan, int nb, int64_t blocks, const WArgs& a,
               float* acc, int win, cudaStream_t stream) {
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  w_bin_win_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(make_plan(plan, nb), a,
                                      WinArgs{acc, win});
  return static_cast<int>(cudaGetLastError());
}

// T3 at K = 0 (svbfm_tpu/parallel/tp_vb.py:459-482): the standalone w
// sweep of the feature-sharded batch VB, K5's bin launch split in two.
// kStats: each column's sum x e over this data shard's rows goes to the
// [D_loc] accumulator acc at its local id; an all-reduce over the data
// shards follows.  !kStats: mode VB's closed form from acc, reading no
// rows (the column's head lane alone works), writing w, the delta table
// and the counts as mode VB does.  Padding columns (local id D_loc) are
// skipped in both.
// T5 (kMCMC, svbfm_tpu/parallel/tp_mcmc.py:158-200): the w draw of the
// feature-sharded Gibbs/ALS from acc, mode MCMC's (X8c's) draw with the
// z table's number at the column's local id, w_new - w_old into the
// delta table as X8c writes it; its stats launch is kStats unchanged.
// T10 (kOVB, svbfm_tpu/parallel/tp_ovb.py:204-244): the feature-sharded
// OVB's w sweep.  kStats sums x (e + x mu_c) as K5's OVB mode does, in its
// lanes and order, so that at a world of one the sums are K5's; !kStats
// is K5's OVB blend (rate rho_w, chunk counts cnt and col_count, the
// naturals, t_wj) from acc, the column's head lane alone working.
template <bool kStats, bool kMCMC = false, bool kOVB = false>
__global__ void __launch_bounds__(kThreads)
    tp_w_kernel(const __grid_constant__ Plan p,
                const __grid_constant__ WArgs a, float* __restrict__ acc,
                int D_loc) {
  int b = 0;
  while (b + 1 < p.nb &&
         p.b[b + 1].first <= static_cast<int64_t>(blockIdx.x))
    ++b;
  const Bucket& bk = p.b[b];
  const int U = col_lanes(bk.L);
  const int64_t c =
      ((static_cast<int64_t>(blockIdx.x) - bk.first) * kThreads +
       threadIdx.x) / U;
  const int li = threadIdx.x & (U - 1);
  const bool live = c < bk.C;
  const int64_t col = live ? __ldg(bk.cols + c) : D_loc;
  const bool real = live && col != D_loc;
  if constexpr (kStats) {
    float s = 0.f;
    if (real) {
      const int L = bk.L;
      const int* __restrict__ crow = bk.rows + c * L;
      const float* __restrict__ cx = bk.x + c * L;
      if constexpr (kOVB) {
        const float mu_c = a.mu_w[col];
        for (int l = li; l < L; l += U) {
          const float xv = __ldg(cx + l);
          const float ev = __ldg(a.e + __ldg(crow + l));
          s += xv * (ev + xv * mu_c);
        }
      } else {
        for (int l = li; l < L; l += U)
          s += __ldg(cx + l) * __ldg(a.e + __ldg(crow + l));
      }
    }
    for (int o = U >> 1; o > 0; o >>= 1)
      s += __shfl_xor_sync(svbfm::kFullMask, s, o);
    if (real && li == 0) acc[col] = s;
  } else if constexpr (kMCMC) {
    if (!real || li != 0) return;
    const int g = __ldg(bk.group + c);
    const float sxx = __ldg(bk.sx2 + c);
    const float alpha = *a.alpha;
    const float w_c = a.mu_w[col], lam = a.sigma_w[g];
    const float s2 = 1.f / (lam + alpha * sxx);
    const float mean =
        -s2 * (alpha * (acc[col] - w_c * sxx) - a.prior_mu[g] * lam);
    float val = a.z != nullptr ? mean + sqrtf(s2) * a.z[col] : mean;
    if (!isfinite(s2)) val = 0.f;  // uncounted, as the reference
    if (isnan(val)) atomicAdd(&a.bad[0], 1);
    if (isinf(val)) atomicAdd(&a.bad[1], 1);
    const float w_new = isfinite(val) ? val : w_c;
    a.mu_w[col] = w_new;
    a.dtab[2 * col] = w_new - w_c;
    a.dtab[2 * col + 1] = 0.f;
  } else if constexpr (kOVB) {  // K5's OVB blend from the summed acc
    if (!real || li != 0) return;
    float* drow = a.dtab + 2 * col;
    const float n = __ldg(bk.cnt + c);
    if (!(n > 0.f)) {
      drow[0] = 0.f;
      drow[1] = 0.f;
      return;
    }
    const int g = __ldg(bk.group + c);
    const float sxx = __ldg(bk.sx2 + c);
    const float cc = __ldg(bk.col_count + c);
    const float alpha = *a.alpha;
    const float mu_c = a.mu_w[col], sig_c = a.sig_w[col];
    const float rho = a.rho_w[col], nmu = a.nmu_w[col];
    const float nsig = a.nsig_w[col];
    const float cnt1 = fmaxf(n, 1.f);
    const float nsig_new =
        (1.f - rho) * nsig + rho * (a.sigma_w[g] + alpha * cc * (sxx / cnt1));
    const float nmu_new =
        (1.f - rho) * nmu + rho * cc * alpha * (acc[col] / cnt1);
    const float mu_cand = nmu_new / nsig_new;
    const float sig_cand = 1.f / nsig_new;
    const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    a.nmu_w[col] = nmu_new;
    a.nsig_w[col] = nsig_new;
    a.t_wj[col] = a.t_wj[col] + n;
    a.mu_w[col] = mu_new;
    a.sig_w[col] = sig_new;
    drow[0] = mu_c - mu_new;
    drow[1] = sig_new - sig_c;
    if (isnan(mu_cand)) atomicAdd(&a.bad[0], 1);
    if (isinf(mu_cand)) atomicAdd(&a.bad[1], 1);
    if (isnan(sig_cand)) atomicAdd(&a.bad[2], 1);
    if (isinf(sig_cand)) atomicAdd(&a.bad[3], 1);
  } else {
    if (!real || li != 0) return;
    const int g = __ldg(bk.group + c);
    const float sxx = __ldg(bk.sx2 + c);
    const float alpha = *a.alpha;
    const float mu_c = a.mu_w[col], sig_c = a.sig_w[col];
    const float s = acc[col];
    const float sig_cand = 1.f / (a.sigma_w[g] + alpha * sxx);
    const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    const float mu_cand = sig_new * alpha * (s + mu_c * sxx);
    const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    a.mu_w[col] = mu_new;
    a.sig_w[col] = sig_new;
    a.dtab[2 * col] = mu_c - mu_new;
    a.dtab[2 * col + 1] = sig_new - sig_c;
    if (isnan(mu_cand)) atomicAdd(&a.bad[0], 1);
    if (isinf(mu_cand)) atomicAdd(&a.bad[1], 1);
    if (isnan(sig_cand)) atomicAdd(&a.bad[2], 1);
    if (isinf(sig_cand)) atomicAdd(&a.bad[3], 1);
  }
}

template <bool kStats, bool kMCMC = false, bool kOVB = false>
int launch_tp(const int64_t* plan, int nb, int64_t blocks, const WArgs& a,
              float* acc, int D_loc, cudaStream_t stream) {
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  tp_w_kernel<kStats, kMCMC, kOVB><<<static_cast<unsigned>(blocks), kThreads,
                                     0, stream>>>(make_plan(plan, nb), a, acc,
                                                  D_loc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every bucket of one bin (plan: nb rows of kPlanCols, `blocks` the sum of
// their ceil(C U / 256), from the wrapper).  Writes mu_w/sig_w [D] and dtab
// [D, 2] at the bin's columns; with ovb != 0 also nmu_w/nsig_w [D] and
// t_wj [D] (+= cnt), reading the plan's cnt/col_count and the rate table
// rho_w [D] (those four pointers are not read when ovb == 0).
SVBFM_EXPORT int svbfm_w_col_update(const int64_t* plan, int nb,
                                    int64_t blocks, const float* e,
                                    float* mu_w, float* sig_w,
                                    const float* sigma_w, const float* alpha,
                                    float* dtab, int* bad, int ovb,
                                    float* nmu_w, float* nsig_w,
                                    const float* rho_w, float* t_wj,
                                    cudaStream_t stream) {
  const WArgs a{e,     mu_w,  sig_w,  sigma_w, nullptr, alpha, nullptr, nmu_w,
                nsig_w, rho_w, t_wj, dtab,    bad,     0.f,   0.f,     1.f};
  return ovb ? launch<kOVB>(plan, nb, blocks, a, stream)
             : launch<kVB>(plan, nb, blocks, a, stream);
}

// X8c, every bucket of one bin of the MCMC/ALS w sweep.  Writes w [D] and
// dtab [D, 2] at the bin's columns; w_mu/w_lambda [G] are the group
// priors, z the [D] noise table (nullptr: ALS, the mean); bad[0], bad[1]
// += the nan, inf draws.
SVBFM_EXPORT int svbfm_mcmc_w_draw(const int64_t* plan, int nb,
                                   int64_t blocks, const float* e, float* w,
                                   const float* w_mu, const float* w_lambda,
                                   const float* alpha, const float* z,
                                   float* dtab, int* bad,
                                   cudaStream_t stream) {
  const WArgs a{e,       w,       nullptr, w_lambda, w_mu, alpha,
                z,       nullptr, nullptr, nullptr,  nullptr, dtab,
                bad,     0.f,     0.f,     1.f};
  return launch<kMCMC>(plan, nb, blocks, a, stream);
}

// K5's gradient mode (X9d), every bucket of one bin of the exp_sgd w
// sweep.  Writes w [D] and dtab [D, 2] = (w_new - w_old, 0) at the bin's
// columns.
SVBFM_EXPORT int svbfm_w_grad_step(const int64_t* plan, int nb,
                                   int64_t blocks, const float* e, float* w,
                                   float* dtab, float lr, float reg,
                                   float n_cases, cudaStream_t stream) {
  const WArgs a{e,       w,       nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, dtab,
                nullptr, lr,      reg,     n_cases};
  return launch<kGrad>(plan, nb, blocks, a, stream);
}

// X13b, every bucket of one window of one bin of the out-of-core VB w
// sweep: the window sums go into acc [D] at the bin's columns in window
// order (win bit 0: the first window, bit 1: the last); the last window's
// launch also writes mu_w/sig_w [D], dtab [D, 2] and the counts bad[4]
// as mode VB does.
SVBFM_EXPORT int svbfm_w_col_window(const int64_t* plan, int nb,
                                    int64_t blocks, const float* e,
                                    float* mu_w, float* sig_w,
                                    const float* sigma_w, const float* alpha,
                                    float* dtab, int* bad, float* acc,
                                    int win, cudaStream_t stream) {
  const WArgs a{e,       mu_w,    sig_w,   sigma_w, nullptr, alpha,
                nullptr, nullptr, nullptr, nullptr, nullptr, dtab,
                bad,     0.f,     0.f,     1.f};
  return launch_win<kVBWin>(plan, nb, blocks, a, acc, win, stream);
}

// X14b, every bucket of one window of one bin of the out-of-core Gibbs/ALS
// w sweep: the window sums go into acc [D] at the bin's columns in window
// order (win bit 0: the first window, bit 1: the last); the last window's
// launch also draws w [D] at the bin's columns with the buckets' global
// sx2 and writes dtab [D, 2] and bad[0], bad[1] as svbfm_mcmc_w_draw does
// (z nullptr: ALS, the mean).
SVBFM_EXPORT int svbfm_mcmc_w_window(const int64_t* plan, int nb,
                                    int64_t blocks, const float* e, float* w,
                                    const float* w_mu, const float* w_lambda,
                                    const float* alpha, const float* z,
                                    float* dtab, int* bad, float* acc,
                                    int win, cudaStream_t stream) {
  const WArgs a{e,       w,       nullptr, w_lambda, w_mu, alpha,
                z,       nullptr, nullptr, nullptr,  nullptr, dtab,
                bad,     0.f,     0.f,     1.f};
  return launch_win<kMCMCWin>(plan, nb, blocks, a, acc, win, stream);
}

// T3 at K = 0, stats: acc [D_loc] at the local ids of one bin's columns =
// their sum x e over this data shard's rows e [N] (padding columns, local
// id D_loc, skipped).
SVBFM_EXPORT int svbfm_tp_w_stats(const int64_t* plan, int nb,
                                  int64_t blocks, const float* e, float* acc,
                                  int D_loc, cudaStream_t stream) {
  const WArgs a{e,       nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, 0.f,     0.f,     1.f};
  return launch_tp<true>(plan, nb, blocks, a, acc, D_loc, stream);
}

// T3 at K = 0, update: mode VB's closed form at one bin's columns from
// acc [D_loc] (summed over the data shards): writes mu_w/sig_w [D_loc],
// dtab [D_loc, 2] and bad[4] as svbfm_w_col_update does.
SVBFM_EXPORT int svbfm_tp_w_update(const int64_t* plan, int nb,
                                   int64_t blocks, const float* acc,
                                   int D_loc, float* mu_w, float* sig_w,
                                   const float* sigma_w, const float* alpha,
                                   float* dtab, int* bad,
                                   cudaStream_t stream) {
  const WArgs a{nullptr, mu_w,    sig_w,   sigma_w, nullptr, alpha,
                nullptr, nullptr, nullptr, nullptr, nullptr, dtab,
                bad,     0.f,     0.f,     1.f};
  return launch_tp<false>(plan, nb, blocks, a, const_cast<float*>(acc),
                          D_loc, stream);
}

// T5, the w draw of the feature-sharded Gibbs/ALS at one bin's columns
// from acc [D_loc] (their sum x e, summed over the data shards): w [D_loc]
// drawn as svbfm_mcmc_w_draw draws it (z the [D_loc] noise table at the
// shard's columns, nullptr: ALS, the mean), dtab [D_loc, 2] = (w_new -
// w_old, 0), bad[0], bad[1] += the NaN, Inf draws; padding columns skipped.
SVBFM_EXPORT int svbfm_tp_w_draw(const int64_t* plan, int nb, int64_t blocks,
                                 const float* acc, int D_loc, float* w,
                                 const float* w_mu, const float* w_lambda,
                                 const float* alpha, const float* z,
                                 float* dtab, int* bad, cudaStream_t stream) {
  const WArgs a{nullptr, w,       nullptr, w_lambda, w_mu,    alpha,
                z,       nullptr, nullptr, nullptr,  nullptr, dtab,
                bad,     0.f,     0.f,     1.f};
  return launch_tp<false, true>(plan, nb, blocks, a, const_cast<float*>(acc),
                                D_loc, stream);
}

// T10, stats: acc [D_loc] at the local ids of one bin's columns = their
// sum x (e + x mu_w[col]) over this data shard's rows e [N], K5's OVB sum
// (padding columns, local id D_loc, skipped).
SVBFM_EXPORT int svbfm_tp_w_ovb_stats(const int64_t* plan, int nb,
                                      int64_t blocks, const float* e,
                                      const float* mu_w, float* acc,
                                      int D_loc, cudaStream_t stream) {
  const WArgs a{e,       const_cast<float*>(mu_w), nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, 0.f,     0.f,     1.f};
  return launch_tp<true, false, true>(plan, nb, blocks, a, acc, D_loc,
                                      stream);
}

// T10, blend: K5's OVB blend at one bin's columns from acc [D_loc] (their
// sums, summed over the data shards), reading the plan's group, sx2, cnt
// and col_count: writes mu_w/sig_w/nmu_w/nsig_w [D_loc], t_wj += cnt,
// dtab [D_loc, 2] and bad[4] as svbfm_w_col_update's OVB mode does.
SVBFM_EXPORT int svbfm_tp_w_ovb_blend(const int64_t* plan, int nb,
                                      int64_t blocks, const float* acc,
                                      int D_loc, float* mu_w, float* sig_w,
                                      const float* sigma_w,
                                      const float* alpha, float* dtab,
                                      int* bad, float* nmu_w, float* nsig_w,
                                      const float* rho_w, float* t_wj,
                                      cudaStream_t stream) {
  const WArgs a{nullptr, mu_w,  sig_w, sigma_w, nullptr, alpha,
                nullptr, nmu_w, nsig_w, rho_w,  t_wj,    dtab,
                bad,     0.f,   0.f,   1.f};
  return launch_tp<false, false, true>(plan, nb, blocks, a,
                                       const_cast<float*>(acc), D_loc,
                                       stream);
}
