// X8a and X8b: one factor block of the Gibbs MCMC / ALS v sweep; X8a's
// gradient mode is the v column step of the full-batch exp_sgd (X9d).  T7
// and T8, the feature-sharded Gibbs/ALS's modes of X14a and X8b (kTP: local
// column ids, the padding column skipped; X8b's patch written, not
// applied), are at the end.
//
// Replaces the per-bin body of svbfm_tpu/learners/mcmc.py:_v_block_pass
// (mcmc.py:361-496) and its factor-sequential form v_factor_main_bins
// (:681-718), whose XLA gather chains are
//   X8a tile_stats (:371-391) + exact_block_draws (:137-200), or the
//       factor-Jacobi draws (:449-459), or the F = 1 body (:684-705):
//       per column c of a [C, L] degree bucket, with
//         h_f  = x (q_f[row] - x v_f,c)                (per entry, factor)
//         s0_f = sum h_f e,  sh2_f = sum h_f^2,  M_fg = sum h_f h_g,
//       the exact sequential draw of the column's F factors,
//         corr = 0; for f: new_f = draw(s0_f - corr_f, sh2_f, ...);
//                          corr_g += (v_f - new_f) M_fg  (g > f);
//   X8b patch_tile (:468-478), and :706-718 at F = 1: the per-bin row
//       patch of the caches from the pre-bin q at every position,
//         q_f -= sum_p x dv_f,  e -= sum_p sum_f h_f dv_f.
// The draw: s2 = 1 / (lambda + alpha sh2),
//   new = -s2 (alpha (she - v sh2) - mu lambda) [+ sqrt(s2) z];
//   a non-finite s2 gives 0, uncounted; a non-finite draw is counted
//   (nans[0] NaN, nans[1] Inf) and reverted to the old value
//   (fm_learn_mcmc.h:686-712).  MCMC's e is yhat - y.
//
// The kernel computes the draw as the recurrence, the loop that JAX runs
// when its batched triangular solve of the same recurrence is not finite.
// The two agree up to rounding, and the loop handles non-finite values the
// same way in every case, so no bucket-wide fallback is needed.
//
// Layouts: row cache q [N, F] row-major (the JAX package keeps [F, N]);
// the factor table v_t [D, F]; the per-bin patch table ptab [D, 2F] with
// channels (v_old, dv): v_old is the pre-bin snapshot that every bucket of
// the bin and the patch read, so X8a writes the new values into v_t in
// place and dv = v_old - v_new into ptab; the group priors mu/lam [G, F];
// the noise table z [F, D] (the JAX draw's shape), nullptr for ALS.
//
// Bound: the random gathers of q and e at the bucket's rows (F + 1 floats
// at a data-dependent address per entry) and of ptab at the row ids, as in
// K3/K4; the cross-factor matrix M adds F(F-1)/2 FMAs per entry (190 at
// F = 20), done from shared memory in float32, never TF32.
//
// X8a, F >= 2 (the exact mode from F = 5; at 2 <= F <= 4 it takes the
// lanes form, col_lanes_body): one block per column.  The block stages a
// tile of kTile entries of h in shared memory as [F, kTile + 1] (the +1
// keeps threads on different factors in different banks), then each
// thread owns some of the 2F + F(F-1)/2 sums (s0, sh2, the strict upper
// triangle of M) and adds the tile into them; the sums live in shared
// memory, owner-written, and a thread finds the pair (f, g) of its sum in
// closed form, so the block needs about (F^2/2 + 39 F) floats (the
// learner takes F <= 303 in the exact mode, learners/mcmc.py:
// factor_width).  After the last tile's barrier,
// warp 0 runs the F-step draw (svbfm::warp_sequential_draws,
// mcmc_draw.cuh, which X10b shares): the corrections in registers (kSlots
// factors a lane: 1 up to F = 32, 2 up to 64, 4 up to 128, 10 beyond),
// the owner lane's v_f - new_f broadcast by a shuffle, no barrier inside
// the F steps; the other warps leave.  Its arithmetic is pinned
// (mcmc_draw.cuh), so the draws' bits do not depend on how the kernel is
// compiled around it.  The draw does not bound the kernel; the M sums
// over each tile do.
// kMode = kJacobi (-factor_jacobi, ALS only) drops M and draws every factor
// from the pre-bin residual at once.  kMode = kGrad (X9d, the v columns of
// svbfm_tpu/learners/exp_sgd.py:exp_sgd_sweep, :120-136) keeps only
// s0 = sum h e, with e = stdev yhat - y, and steps every factor at once:
//   v' = keep_finite(v - lr (s0 + regv v) / N, v);
// no sh2, no M, no draw, no counters.  It fills ptab's dv channels as the
// draw modes do, so X8b patches q and e after the bin unchanged.
// X8a, F = 1: lanes over a column's slots, no lane idle on an absent
// factor.  Bound by the rate at which the card serves random 4-byte
// gathers (two a real entry, q and e at its row, each its own 32-byte
// sector: P1's 2M random indices take 17.8 us on the H100), not by their
// latency: each lane loads its slots' ids and x with vector loads and
// issues all their gathers before its first FMA, a warp a column (2-4 on
// long columns, a few lanes on short ones); see col_draw_f1_kernel.
// X14a, the window-accumulating mode (kWin, the out-of-core Gibbs/ALS of
// svbfm_tpu/learners/mcmc_windowed.py:339-398, make_stats + make_draw):
// the bucket is one window's [C, L] view of a global column bucket, its
// rows local to the window, and e, q the window's rows of the resident
// caches (base pointers at the window's first row).  The block's sums
// (s0 | sh2 | M packed, the layout of the draw) go to the [C, nout]
// accumulator gacc in window order: the first window writes them, every
// later one adds its sums to what is there (JAX's a + x); each sum's
// owner thread writes it, so no atomics.  Only the last window's launch
// runs the exact sequential draw, on the accumulated sums, and writes v_t,
// ptab's dv channels and the counts, as the resident exact mode does.
// F = 1 takes col_draw_f1_kernel's form (lanes over a column's slots, at
// the card's gather rate, as the resident F = 1 sweep) with the column's
// head lane adding its (s0, sh2) into gacc [C, 2]; the block form at F = 1
// would idle most of its 128 threads on one factor, and 2 <= F <= 4 the
// lanes form's (col_lanes_body), which the resident exact mode takes at
// those widths too, so one window gives the resident draws' bits.  The
// mode is a template parameter of each body.
// X8b: bound by bytes, the [N, F] cache read and written once and each
// row's ids, x and e (186 MB at ML-1M, F = 20: 55 us at 3.35 TB/s); its
// ptab rows (2F floats an attribute) stay in L2.  A warp a row, lanes
// over factors, would leave 12 of 32 lanes idle at F = 20 and cover one
// row with each latency chain ids -> ptab -> FMA -> shuffle -> e (4.5x the
// bound on the H100).  So at F >= 2 a row's V-float factor chunks lie
// over TPR lanes, several rows a warp, and at F = 1 a thread takes a row.
// Each row owns its cache slots: no races.
#include <algorithm>

#include "mcmc_draw.cuh"

namespace {

constexpr int kTile = 32;
// X8a at F = 1: threads a block, and the slots a lane loads a round
// before its first FMA (8 gathers in flight a lane; 8 slots, 16 gathers,
// ran no faster on the H100: the card's rate of random 4-byte gathers
// bounds the kernel, not their latency)
constexpr int kF1Threads = 256;
constexpr int kF1Slots = 4;
constexpr int kPatchThreads = 256;
constexpr int kPatchPos = 2;  // X8b's positions whose loads go out together
constexpr int kExact = 0, kJacobi = 1, kGrad = 2;

using svbfm::chunk_width;
using svbfm::load_vec;
using svbfm::store_vec;

// The gradient step of X9d (exp_sgd.py:131-132).
__device__ __forceinline__ float grad_step(float v, float s, float lr,
                                           float reg, float n) {
  const float nv = v - lr * (s + reg * v) / n;
  return isfinite(nv) ? nv : v;
}

// Sums a column owns: s0 [F], then sh2 [F] (draw modes), then the packed M
// (exact mode).
__host__ __device__ __forceinline__ int col_outputs(int mode, int F) {
  return mode == kGrad ? F
                       : 2 * F + (mode == kExact ? F * (F - 1) / 2 : 0);
}

// One column's block (the kernels below); kSlots: the factors a lane of
// the exact draw holds (svbfm::with_draw_slots).
// kWin: X14a's window mode (exact draws only), gacc [C, nout] the
// accumulator and win its place (bit 0 the first window, bit 1 the last).
// kTP: T7's (with kWin; exact or factor-Jacobi draws): cols are local ids
// of a feature shard of D columns, and a padding column (id D) is skipped.
template <int kMode, int kSlots, bool kWin = false, bool kTP = false>
__device__ __forceinline__ void col_draw_block(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float lr, float reg, float n_cases,
    float* __restrict__ gacc = nullptr, int win = 0) {
  static_assert(!kWin || kMode == kExact || (kTP && kMode == kJacobi),
                "X14a draws exactly");
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = blockIdx.x;
  const int nout = col_outputs(kMode, F);
  const int ld = kTile + 1;
  float* acc = smem;             // [nout]: s0 | sh2 | M (packed)
  float* hs = acc + nout;        // [F, kTile + 1]
  float* es = hs + F * ld;       // [kTile]
  float* vc = es + kTile;        // [F] pre-bin v of the column
  float* prior = vc + F;         // [3, F]: mu, lambda, z

  const int64_t col = cols[c];
  if (kTP && col >= D) return;  // a padding column: the whole block leaves
  const int64_t ldp = 2 * F;
  // the draw's operands: not read by a window before the last
  const bool draws = kMode != kGrad && (!kWin || (win & 2));
  for (int f = tid; f < F; f += nt) {
    vc[f] = ptab[col * ldp + f];
    if (draws) {
      const int g_c = group[c];
      prior[f] = mu[g_c * F + f];
      prior[F + f] = lam[g_c * F + f];
      prior[2 * F + f] = z != nullptr ? z[f * D + col] : 0.f;
    }
  }
  for (int o = tid; o < nout; o += nt) acc[o] = 0.f;
  // the pair of this thread's first sum, found once (at F <= 21 a thread
  // owns at most one sum); later ones are found per tile
  const int fg0 = kMode == kExact && tid >= 2 * F && tid < nout
                      ? svbfm::pair_at(tid - 2 * F, F) : 0;
  __syncthreads();

  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int nl = min(kTile, L - l0);
    for (int i = tid; i < kTile * F; i += nt) {
      const int l = i / F;
      const int f = i - l * F;
      float h = 0.f;
      if (l < nl) {
        const int64_t r = crow[l0 + l];
        const float xv = cx[l0 + l];
        h = xv * (q[r * F + f] - xv * vc[f]);
        if (f == 0) es[l] = e[r];
      } else if (f == 0) {
        es[l] = 0.f;
      }
      hs[f * ld + l] = h;
    }
    __syncthreads();
    for (int o = tid; o < nout; o += nt) {
      float s = 0.f;
      if (o < F) {
        const float* hf = hs + o * ld;
        for (int l = 0; l < kTile; ++l) s += hf[l] * es[l];
      } else if (o < 2 * F) {
        const float* hf = hs + (o - F) * ld;
        for (int l = 0; l < kTile; ++l) s += hf[l] * hf[l];
      } else {
        const int fg = o == tid ? fg0 : svbfm::pair_at(o - 2 * F, F);
        const float* hf = hs + (fg >> 16) * ld;
        const float* hg = hs + (fg & 0xffff) * ld;
        for (int l = 0; l < kTile; ++l) s += hf[l] * hg[l];
      }
      acc[o] += s;
    }
    __syncthreads();
  }

  if (kWin) {  // X14a: the window's sums into gacc, in window order
    float* arow = gacc + static_cast<int64_t>(c) * nout;
    for (int o = tid; o < nout; o += nt) {
      const float tot = (win & 1) ? acc[o] : arow[o] + acc[o];
      if (win & 2) {
        acc[o] = tot;
      } else {
        arow[o] = tot;
      }
    }
    if (!(win & 2)) return;
    __syncthreads();  // the draw reads every owner's total
  }

  if (kMode == kGrad) {  // exp_sgd.py:129-136: every factor at once
    for (int f = tid; f < F; f += nt) {
      const float v_f = vc[f];
      const float nv = grad_step(v_f, acc[f], lr, reg, n_cases);
      v_t[col * F + f] = nv;
      ptab[col * ldp + F + f] = v_f - nv;
    }
    return;
  }
  const float alpha = *alpha_p;
  const bool has_z = z != nullptr;
  int nan_c = 0, inf_c = 0;
  if (kMode == kJacobi) {
    // factor-Jacobi (mcmc.py:449-459): every factor from the pre-bin e
    for (int f = tid; f < F; f += nt) {
      const float v_f = vc[f];
      const float nv = svbfm::draw_one<true>(
          acc[f], acc[F + f], v_f, prior[f], prior[F + f], alpha, has_z,
          prior[2 * F + f], nan_c, inf_c);
      v_t[col * F + f] = nv;
      ptab[col * ldp + F + f] = v_f - nv;
    }
  } else {
    // the sums are complete (the tile loop ends on a barrier): warp 0
    // draws, the other warps are done
    if (tid >= 32) return;
    svbfm::warp_sequential_draws<kSlots>(acc, F, vc, prior, alpha, has_z,
                                 v_t + col * F, ptab + col * ldp + F, nan_c,
                                 inf_c);
  }
  if (nan_c) atomicAdd(&nans[0], nan_c);
  if (inf_c) atomicAdd(&nans[1], inf_c);
}

template <int kMode, int kSlots>
__global__ void col_draw_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float lr, float reg, float n_cases) {
  col_draw_block<kMode, kSlots>(rows, x, L, cols, group, e, q, F, ptab, v_t,
                                mu, lam, alpha_p, z, D, nans, lr, reg,
                                n_cases);
}

// The exact mode at F <= 32 (one factor a lane in the draw), held to 42
// registers a thread so that six blocks of 256 share an SM: at F = 20 on
// the H100 it runs 10 % faster than with the 48 registers ptxas picks
// unbounded (five blocks), a 4-byte spill included.  The other modes and
// widths keep ptxas's own choice: bounds raised their registers and slowed
// them.
__global__ void __launch_bounds__(256, 6) col_draw_exact32_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float lr, float reg, float n_cases) {
  col_draw_block<kExact, 1>(rows, x, L, cols, group, e, q, F, ptab, v_t, mu,
                            lam, alpha_p, z, D, nans, lr, reg, n_cases);
}

// X14a's kernels at F >= 2: the exact mode's two builds with the window
// accumulator (the F <= 32 one under the same register bound).  kTP: T7's
// builds (kMode kExact, or kJacobi under -factor_jacobi ALS).
template <int kSlots, bool kTP = false, int kMode = kExact>
__global__ void col_draw_win_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float lr, float reg, float n_cases,
    float* __restrict__ gacc, int win) {
  col_draw_block<kMode, kSlots, true, kTP>(rows, x, L, cols, group, e, q, F,
                                           ptab, v_t, mu, lam, alpha_p, z, D,
                                           nans, lr, reg, n_cases, gacc, win);
}

template <bool kTP = false>
__global__ void __launch_bounds__(256, 6) col_draw_win32_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float lr, float reg, float n_cases,
    float* __restrict__ gacc, int win) {
  col_draw_block<kExact, 1, true, kTP>(rows, x, L, cols, group, e, q, F, ptab,
                                       v_t, mu, lam, alpha_p, z, D, nans, lr,
                                       reg, n_cases, gacc, win);
}

// X8a at F = 1 (v_factor_main_bins, mcmc.py:684-705), with kGradF1 the
// exp_sgd step of one factor (exp_sgd.py:129-136 at F = 1): G lanes a
// column of a [C, L] bucket (f1_lanes), kF1Threads / G columns a block.
// A lane takes V consecutive slots a load (16-, 8- or 4-byte loads of
// rows and x, as L and the bases allow), kF1Slots slots a round, and
// issues all of their q and e gathers before its first FMA.  The lanes'
// sums close by a butterfly (G <= 32) or, where G is 2-4 warps, by the
// warps' butterflies and then their partials in warp order through
// shared memory; either way a fixed order, so two launches give the same
// bits.  The column's first lane loads the draw's operands at the start
// and draws.
// Padding (svbfm::PadRow): of the x = 0 slots at the pad row only the last
// slot is gathered, so a non-finite q or e there still makes the sums NaN,
// as in the twin.
// kWin (X14a at F = 1): the head lane adds the column's (s0, sh2) into gacc
// [C, 2] in window order; only the last window's launch draws.  kTP (T7):
// cols are local ids of a feature shard of D columns, a padding column (id
// D) is not live.
template <bool kGradF1, int V, bool kWin, bool kTP = false>
__device__ __forceinline__ void col_f1_body(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int G, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int* __restrict__ nans, float lr, float reg, float n_cases,
    float* __restrict__ gacc, int win, int64_t D = 0) {
  constexpr int kR = kF1Slots / V;  // loads of V slots a lane a round
  __shared__ float part[2][kF1Threads / 32];
  const int tid = threadIdx.x;
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * (kF1Threads / G) + tid / G;
  const int li = tid & (G - 1);
  const bool live = c < C && (!kTP || cols[c] < D);
  float s0 = 0.f, sh2 = 0.f;
  int64_t col = 0;
  float v_c = 0.f, mu_c = 0.f, lam_c = 0.f, alpha = 0.f, zc = 0.f;
  if (live) {
    col = cols[c];
    v_c = ptab[2 * col];
    if (!kGradF1 && li == 0 && (!kWin || (win & 2))) {
      const int g_c = group[c];
      mu_c = mu[g_c];
      lam_c = lam[g_c];
      alpha = *alpha_p;
      if (z != nullptr) zc = z[col];
    }
    const int* crow = rows + c * L;
    const float* cx = x + c * L;
    const svbfm::PadRow pr(crow, cx, L);
    const int nch = L / V;
    for (int j0 = li; j0 < nch; j0 += G * kR) {
      int r[kR][V];
      float xv[kR][V];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int j = j0 + i * G;
        if (j < nch) {
          load_vec<V>(crow + j * V, r[i]);
          load_vec<V>(cx + j * V, xv[i]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            r[i][k] = 0;
            xv[i][k] = 0.f;
          }
        }
      }
      bool keep[kR][V];
      float qv[kR][V], ev[kR][V];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int l = (j0 + i * G) * V + k;
          keep[i][k] = l < L && pr.gathers(l, r[i][k], xv[i][k]);
          qv[i][k] = keep[i][k] ? q[r[i][k]] : 0.f;
          ev[i][k] = keep[i][k] ? e[r[i][k]] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (!keep[i][k]) continue;
          const float xk = xv[i][k];
          const float h = xk * (qv[i][k] - xk * v_c);
          s0 += h * ev[i][k];
          if (!kGradF1) sh2 += h * h;
        }
      }
    }
  }
  if (G <= 32) {
    for (int o = G >> 1; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(svbfm::kFullMask, s0, o);
      if (!kGradF1) sh2 += __shfl_xor_sync(svbfm::kFullMask, sh2, o);
    }
  } else {  // G / 32 warps a column: every warp of the block gets here
    s0 = svbfm::warp_sum(s0);
    if (!kGradF1) sh2 = svbfm::warp_sum(sh2);
    const int warp = tid >> 5;
    if ((tid & 31) == 0) {
      part[0][warp] = s0;
      part[1][warp] = sh2;
    }
    __syncthreads();
    if (li == 0) {
      for (int w = 1; w < G / 32; ++w) {
        s0 += part[0][warp + w];
        sh2 += part[1][warp + w];
      }
    }
  }
  if (!live || li != 0) return;
  if (kWin) {
    float* arow = gacc + 2 * c;
    const float t0 = (win & 1) ? s0 : arow[0] + s0;
    const float t1 = (win & 1) ? sh2 : arow[1] + sh2;
    if (!(win & 2)) {
      arow[0] = t0;
      arow[1] = t1;
      return;
    }
    s0 = t0;
    sh2 = t1;
  }
  if (kGradF1) {
    const float nv = grad_step(v_c, s0, lr, reg, n_cases);
    v_t[col] = nv;
    ptab[2 * col + 1] = v_c - nv;
    return;
  }
  int nan_c = 0, inf_c = 0;
  const float nv = svbfm::draw_one(s0, sh2, v_c, mu_c, lam_c, alpha,
                                   z != nullptr, zc, nan_c, inf_c);
  v_t[col] = nv;
  ptab[2 * col + 1] = v_c - nv;
  if (nan_c) atomicAdd(&nans[0], nan_c);
  if (inf_c) atomicAdd(&nans[1], inf_c);
}

template <bool kGradF1, int V>
__global__ void __launch_bounds__(kF1Threads) col_draw_f1_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int G, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int* __restrict__ nans, float lr, float reg, float n_cases) {
  col_f1_body<kGradF1, V, false>(rows, x, C, L, G, cols, group, e, q, ptab,
                                 v_t, mu, lam, alpha_p, z, nans, lr, reg,
                                 n_cases, nullptr, 0);
}

// X14a at F = 1: the draw mode with the window accumulator (kTP: T7's, D
// the shard's columns; unread otherwise).
template <int V, bool kTP = false>
__global__ void __launch_bounds__(kF1Threads) col_draw_f1_win_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int G, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int* __restrict__ nans, float lr, float reg, float n_cases,
    float* __restrict__ gacc, int win, int64_t D) {
  col_f1_body<false, V, true, kTP>(rows, x, C, L, G, cols, group, e, q, ptab,
                                   v_t, mu, lam, alpha_p, z, nans, lr, reg,
                                   n_cases, gacc, win, D);
}

// X8a's exact mode at 2 <= F <= kLanesMaxF, resident and in X14a's window
// mode (kWin): U lanes a column of a [C, L] bucket (col_lanes: the next
// power of two >= L / 8, or >= L / 4 where C < 2048, 4 to 32), up to
// kLanesThreads / U columns a block (fewer where C is small, so that the
// columns spread over the SMs, but never less than two warps:
// svbfm::lanes_block_cols).
// Lane li takes slots li, li + U, ... (consecutive lanes on consecutive
// slots, so the group's row and x loads are contiguous), kLanesRound a
// round: their ids and x, then every e and q-row gather (one QW-float load
// a row piece: 16 bytes at F = 4), then the FMAs.  All 2F + F(F-1)/2 sums
// (s0 | sh2 | M packed, 14 at F = 4) stay in registers across the lane's
// slots and close by a butterfly over the column's lanes, a fixed order in
// which every lane gets the same totals: no shared-memory tile and no
// barrier.  The block form's 128 threads on one column left 114 of them
// idle in its serial sums at F = 4, two barriers a 32-slot tile.
// kTP (T7, with kWin): cols are local ids of a feature shard of D columns,
// and a padding column (id D) is not live: nothing read, nothing written.
// Padding: svbfm::PadRow, as at F = 1.  kWin: the window's sums go to
// gacc [C, nout] in window order, each sum's owner lane (sum k, lane
// k mod U) writing it (the first window), or adding it to what is there;
// only the last window's launch draws.  The draw: the owner lanes put the
// sums, v and the priors in the column's slab of shared memory, and
// svbfm::group_sequential_draws runs on it with groups of kLanesDraw lanes
// (a factor a lane); the column's first group writes and counts, any
// other group of its lanes repeats the same steps and drops them.
constexpr int kLanesThreads = 256;
constexpr int kLanesMaxF = 4;
constexpr int kLanesRound = 4;  // slots a lane gathers before its FMAs
constexpr int kLanesDraw = 4;   // lanes of the draw's group, >= kLanesMaxF

template <int kF, int QW, bool kWin, bool kTP = false>
__device__ __forceinline__ void col_lanes_body(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int U, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float* __restrict__ gacc, int win) {
  constexpr int kOut = 2 * kF + kF * (kF - 1) / 2;  // s0 | sh2 | M packed
  constexpr int kPri = 3 * kF;                      // mu | lambda | z
  __shared__ float slab[kLanesThreads / kLanesDraw][kOut + kF + kPri];
  const int tid = threadIdx.x;
  const int cb = tid / U;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (blockDim.x / U) + cb;
  const int li = tid & (U - 1);
  const bool live = c < C && (!kTP || cols[c] < D);
  const bool draws = !kWin || (win & 2);
  // prev: the lane's entries of the window accumulator, loaded ahead of
  // the gathers
  float s[kOut], prev[kOut], vc[kF], pri[kPri];
#pragma unroll
  for (int k = 0; k < kOut; ++k) s[k] = prev[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kPri; ++i) pri[i] = 0.f;
  int64_t col = 0;
  float alpha = 0.f;
  float* arow = kWin ? gacc + c * kOut : nullptr;
  if (live) {
    col = cols[c];
    if (kWin && !(win & 1)) {
#pragma unroll
      for (int k = 0; k < kOut; ++k)
        if ((k & (U - 1)) == li) prev[k] = arow[k];
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) vc[f] = ptab[col * (2 * kF) + f];
    if (draws) {  // the draw's operands, each loaded by its owner lane
      alpha = *alpha_p;
      const int g_c = group[c];
#pragma unroll
      for (int i = 0; i < kPri; ++i) {
        if ((i & (U - 1)) != li) continue;
        const int f = i % kF;
        pri[i] = i < kF       ? mu[g_c * kF + f]
                 : i < 2 * kF ? lam[g_c * kF + f]
                 : z != nullptr ? z[f * D + col]
                                : 0.f;
      }
    }
    const int* crow = rows + c * L;
    const float* cx = x + c * L;
    const svbfm::PadRow pr(crow, cx, L);
    for (int l0 = li; l0 < L; l0 += U * kLanesRound) {
      int r[kLanesRound];
      float xv[kLanesRound];
#pragma unroll
      for (int i = 0; i < kLanesRound; ++i) {
        const int l = l0 + i * U;
        r[i] = l < L ? crow[l] : 0;
        xv[i] = l < L ? cx[l] : 0.f;
      }
      bool keep[kLanesRound];
      float ev[kLanesRound], qv[kLanesRound][kF];
#pragma unroll
      for (int i = 0; i < kLanesRound; ++i) {
        const int l = l0 + i * U;
        keep[i] = l < L && pr.gathers(l, r[i], xv[i]);
        ev[i] = keep[i] ? e[r[i]] : 0.f;
        if (keep[i]) {
          load_vec<kF, QW>(q + static_cast<int64_t>(r[i]) * kF, qv[i]);
        } else {
#pragma unroll
          for (int f = 0; f < kF; ++f) qv[i][f] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kLanesRound; ++i) {
        if (!keep[i]) continue;
        const float xk = xv[i];
        float h[kF];
#pragma unroll
        for (int f = 0; f < kF; ++f) h[f] = xk * (qv[i][f] - xk * vc[f]);
        int p = 2 * kF;
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          s[f] += h[f] * ev[i];
          s[kF + f] += h[f] * h[f];
#pragma unroll
          for (int g = f + 1; g < kF; ++g) s[p++] += h[f] * h[g];
        }
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < kF; ++f) vc[f] = 0.f;
  }
  for (int o = U >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      s[k] += __shfl_xor_sync(svbfm::kFullMask, s[k], o);
  }
  float* sl = slab[cb];
  if (kWin) {  // X14a: the window's sums into gacc, in window order
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      if ((k & (U - 1)) != li) continue;
      const float tot = (win & 1) || !live ? s[k] : prev[k] + s[k];
      if (win & 2) {
        sl[k] = tot;
      } else if (live) {
        arow[k] = tot;
      }
    }
    if (!(win & 2)) return;  // the whole warp leaves: win is the launch's
  } else {
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      if ((k & (U - 1)) == li) sl[k] = s[k];
  }
#pragma unroll
  for (int f = 0; f < kF; ++f)
    if ((f & (U - 1)) == li) sl[kOut + f] = vc[f];
#pragma unroll
  for (int i = 0; i < kPri; ++i)
    if ((i & (U - 1)) == li) sl[kOut + kF + i] = pri[i];
  __syncwarp();
  int nan_c = 0, inf_c = 0;
  const bool write = live && li < kLanesDraw;
  svbfm::group_sequential_draws<kLanesDraw, 1>(
      sl, kF, sl + kOut, sl + kOut + kF, alpha, z != nullptr, write,
      v_t + col * kF, ptab + col * (2 * kF) + kF, nan_c, inf_c);
  if (!write) return;
  if (nan_c) atomicAdd(&nans[0], nan_c);
  if (inf_c) atomicAdd(&nans[1], inf_c);
}

template <int kF, int QW>
__global__ void __launch_bounds__(kLanesThreads) col_draw_lanes_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int U, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans) {
  col_lanes_body<kF, QW, false>(rows, x, C, L, U, cols, group, e, q, ptab,
                                v_t, mu, lam, alpha_p, z, D, nans, nullptr,
                                0);
}

// X14a at 2 <= F <= kLanesMaxF: the lanes form with the window accumulator
// (kTP: T7's).
template <int kF, int QW, bool kTP = false>
__global__ void __launch_bounds__(kLanesThreads) col_draw_win_lanes_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int U, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ e, const float* __restrict__ q,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t D, int* __restrict__ nans, float* __restrict__ gacc, int win) {
  col_lanes_body<kF, QW, true, kTP>(rows, x, C, L, U, cols, group, e, q,
                                    ptab, v_t, mu, lam, alpha_p, z, D, nans,
                                    gacc, win);
}

// X8b at F = 1: a thread a row.  Every position reads the pre-bin q; dq
// is applied after the last.
// kTP (T8, svbfm_tpu/parallel/tp_mcmc.py:284-301): X8b's delta mode over
// the ids of one feature shard [lo, lo + D_loc) (ptab's rows at the local
// ids, the other ids skipped): dq and de are written to out (dq [N, F],
// then de [N]) and not applied, for the feature all-reduce to sum.
template <bool kTP = false>
__global__ void row_patch_f1_kernel(const float* __restrict__ ptab,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ vals, int64_t N,
                                    int P, float* __restrict__ q,
                                    float* __restrict__ e, int64_t lo,
                                    int D_loc, float* __restrict__ out) {
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kPatchThreads + threadIdx.x;
  if (n >= N) return;
  const float qv = q[n];
  float de = 0.f, dq = 0.f;
  for (int p = 0; p < P; ++p) {
    int64_t id = ids[n * P + p];
    if constexpr (kTP) {
      id -= lo;
      if (id < 0 || id >= D_loc) continue;  // another shard's id
    }
    const float* g = ptab + id * 2;
    const float xv = vals[n * P + p];
    const float dv = g[1];
    de += xv * (qv - xv * g[0]) * dv;
    dq += xv * dv;
  }
  if constexpr (kTP) {
    out[n] = dq;
    out[N + n] = de;
  } else {
    q[n] = qv - dq;
    e[n] -= de;
  }
}

// X8b at F >= 2: TPR = min(F / V, 32) lanes a row, 32 / TPR rows a warp
// (the resync's layout, bs_forward.cu:resync_chunks_kernel), lane j of a
// row owning the V-factor chunks j, j + TPR, ... (at F = 20: 5 lanes of 4
// factors, 6 rows a warp).  Consecutive lanes hold consecutive chunks of
// consecutive rows, so q is read and written in V-float loads over a
// contiguous run of the [N, F] cache.  A chunk's pre-bin q and its dq stay
// in registers across the positions, which come kPatchPos at a time: their
// ids and x, then their ptab pieces (v_old at f, dv at F + f), then their
// sums in position order.  The row's first lane loads e[n] before its
// chunks; the chunk sums of de meet by a segmented shuffle over the row's
// lanes (a fixed order), with no barrier.  kP = 2 builds the kernel for
// rows of two positions (ML-1M's rows hold a user and an item): its loops
// unroll whole and it takes fewer registers, so that more blocks share an
// SM; kP = 0 takes any P.  The bound is the bytes of q; what costs is the
// rows an SM holds in flight (K4's form, rows over the threads of a block
// with the sums met in shared memory behind a barrier and the next
// position's pieces loaded ahead, needs more registers and ran about 1.4x
// slower on the H100).
// kTP (T8): the delta mode of row_patch_f1_kernel's kTP, the chunks' dq
// and the row's de written to out.
template <int V, int kP, bool kTP = false>
__global__ void __launch_bounds__(kPatchThreads)
    row_patch_wide_kernel(const float* __restrict__ ptab, int F,
                          const int* __restrict__ ids,
                          const float* __restrict__ vals, int64_t N,
                          int P_any, int TPR, float* __restrict__ q,
                          float* __restrict__ e, int64_t lo, int D_loc,
                          float* __restrict__ out) {
  const int P = kP > 0 ? kP : P_any;
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / TPR;  // rows a warp
  const int slot = lane / TPR;
  const int j = lane - slot * TPR;
  const int64_t n0 =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      rpw;
  if (n0 >= N) return;  // the whole warp leaves
  const int64_t n = n0 + slot;
  const bool valid = slot < rpw && n < N;
  const int G = F / V;
  const int64_t ldp = 2 * F;
  float de = 0.f, ev = 0.f;
  if (valid) {
    if constexpr (!kTP) {
      if (j == 0) ev = e[n];
    }
    const int* nid = ids + n * P;
    const float* nx = vals + n * P;
    for (int ch = j; ch < G; ch += 32) {  // TPR = G where G <= 32
      const int f0 = ch * V;
      const int64_t o = n * F + f0;
      float q0[V], dq[V];
      load_vec<V>(q + o, q0);
#pragma unroll
      for (int k = 0; k < V; ++k) dq[k] = 0.f;
      for (int p0 = 0; p0 < P; p0 += kPatchPos) {
        int id[kPatchPos];
        bool use[kPatchPos];  // kTP: the position's id is the shard's
        float xv[kPatchPos], g[kPatchPos][2][V];
#pragma unroll
        for (int b = 0; b < kPatchPos; ++b) {
          const bool in = p0 + b < P;
          id[b] = in ? nid[p0 + b] : 0;
          xv[b] = in ? nx[p0 + b] : 0.f;
          if constexpr (kTP) {
            const int64_t loc = static_cast<int64_t>(id[b]) - lo;
            use[b] = in && loc >= 0 && loc < D_loc;
            id[b] = use[b] ? static_cast<int>(loc) : 0;
          }
        }
#pragma unroll
        for (int b = 0; b < kPatchPos; ++b) {
          if (kTP ? use[b] : p0 + b < P) {
            const float* row = ptab + static_cast<int64_t>(id[b]) * ldp + f0;
            load_vec<V>(row, g[b][0]);
            load_vec<V>(row + F, g[b][1]);
          }
        }
#pragma unroll
        for (int b = 0; b < kPatchPos; ++b) {
          if (kTP ? use[b] : p0 + b < P) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float dv = g[b][1][k];
              de += xv[b] * (q0[k] - xv[b] * g[b][0][k]) * dv;
              dq[k] += xv[b] * dv;
            }
          }
        }
      }
      if constexpr (kTP) {
        store_vec<V>(out + o, dq);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) q0[k] -= dq[k];
        store_vec<V>(q + o, q0);
      }
    }
  }
  for (int d = 1; d < TPR; d <<= 1) {
    const float t = __shfl_down_sync(svbfm::kFullMask, de, d);
    if (j + d < TPR) de += t;
  }
  if constexpr (kTP) {
    if (valid && j == 0) out[N * F + n] = de;
  } else {
    if (valid && j == 0) e[n] = ev - de;
  }
}

// Mirrored by kernels/mcmc_sweep.py:col_draw_smem.
size_t col_draw_smem(int F, int mode) {
  return sizeof(float) * (col_outputs(mode, F) + F * (kTile + 1) + kTile +
                          4 * F);
}

// X8a's kernel for a mode and a draw's slots (kWin: X14a's; kTP: T7's).
template <int kMode, int kSlots, bool kWin, bool kTP = false>
auto col_draw_entry() {
  if constexpr (kWin && kSlots == 1 && kMode == kExact) {
    return col_draw_win32_kernel<kTP>;
  } else if constexpr (kWin) {
    return col_draw_win_kernel<kSlots, kTP, kMode>;
  } else if constexpr (kMode == kExact && kSlots == 1) {
    return col_draw_exact32_kernel;
  } else {
    return col_draw_kernel<kMode, kSlots>;
  }
}

template <int kMode, int kSlots, bool kWin = false, bool kTP = false>
int launch_col_draw(const int* rows, const float* x, int C, int L,
                    const int* cols, const int* group, const float* e,
                    const float* q, int F, float* ptab, float* v_t,
                    const float* mu, const float* lam, const float* alpha,
                    const float* z, int64_t D, int* nans, float lr, float reg,
                    float n_cases, cudaStream_t stream,
                    float* gacc = nullptr, int win = 0) {
  const size_t smem = col_draw_smem(F, kMode);
  const int threads = col_outputs(kMode, F) > 128 ? 256 : 128;
  if (kMode == kExact && F > 32 * kSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = col_draw_entry<kMode, kSlots, kWin, kTP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (kWin) {
    kernel<<<C, threads, smem, stream>>>(rows, x, L, cols, group, e, q, F,
                                         ptab, v_t, mu, lam, alpha, z, D,
                                         nans, lr, reg, n_cases, gacc, win);
  } else {
    kernel<<<C, threads, smem, stream>>>(rows, x, L, cols, group, e, q, F,
                                         ptab, v_t, mu, lam, alpha, z, D,
                                         nans, lr, reg, n_cases);
  }
  return static_cast<int>(cudaGetLastError());
}

// X8a at F = 1's lanes a column of a [C, L] bucket (mirrored by
// kernels/mcmc_sweep.py:col_draw_f1_lanes): where L <= 16 (real data's
// small degree buckets) the next power of two >= L, a slot a lane, several
// columns a warp; past it a warp, 8 slots a lane, or 2-4 warps where L is
// long (more than 256 slots, or 128 in a bucket of fewer than 2,048
// columns, which would leave the SMs few warps).
int f1_lanes(int C, int L) {
  if (L <= 16) {
    int G = 1;
    while (G < L) G <<= 1;
    return G;
  }
  const int per = C < 2048 ? 128 : 256;
  return 32 * std::min(4, (L + per - 1) / per);
}

// The slots a lane loads at once: 4 or 2 where L and the bases of rows and
// x allow 16- or 8-byte loads, else 1 (mirrored by kernels/mcmc_sweep.py:
// col_draw_f1_plan).
int f1_vec(const int* rows, const float* x, int L, int G) {
  if (G < 32) return 1;
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows) |
                      reinterpret_cast<uintptr_t>(x);
  if (L % 4 == 0 && a % 16 == 0) return 4;
  if (L % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// X8a's lanes a column in its lanes form (mirrored by kernels/
// mcmc_sweep.py:col_draw_lanes): the next power of two >= L / 8 (at most
// 8 slots a lane; 4 in a bucket of fewer than 2,048 columns, which would
// leave the SMs few warps), at least the draw's kLanesDraw, at most a warp
// (more slots a lane past L = 256 or 128).
int col_lanes(int C, int L) {
  const int per = C < 2048 ? 4 : 8;
  int U = kLanesDraw;
  while (U < 32 && U * per < L) U <<= 1;
  return U;
}

// X8a's exact mode (kWin: X14a) at 2 <= F <= kLanesMaxF in the lanes form,
// each q row read in loads of QW floats, the widest of 4, 2, 1 that
// divides F and q's alignment allows.
template <bool kWin, bool kTP = false>
int launch_col_lanes(const int* rows, const float* x, int C, int L,
                     const int* cols, const int* group, const float* e,
                     const float* q, int F, float* ptab, float* v_t,
                     const float* mu, const float* lam, const float* alpha,
                     const float* z, int64_t D, int* nans,
                     cudaStream_t stream, float* gacc = nullptr,
                     int win = 0) {
  const int U = col_lanes(C, L);
  const int cpb = svbfm::lanes_block_cols(C, U, kLanesThreads);
  const int threads = cpb * U;
  const unsigned blocks = static_cast<unsigned>((C + cpb - 1) / cpb);
  auto go = [&](auto f, auto w) {
    constexpr int kF = decltype(f)::value;
    constexpr int kQW = decltype(w)::value;
    if constexpr (kWin) {
      col_draw_win_lanes_kernel<kF, kQW, kTP><<<blocks, threads, 0, stream>>>(
          rows, x, C, L, U, cols, group, e, q, ptab, v_t, mu, lam, alpha, z,
          D, nans, gacc, win);
    } else {
      col_draw_lanes_kernel<kF, kQW><<<blocks, threads, 0, stream>>>(
          rows, x, C, L, U, cols, group, e, q, ptab, v_t, mu, lam, alpha, z,
          D, nans);
    }
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  const int qw = chunk_width(F, q);
  switch (F) {
    case 2:
      qw == 2 ? go(I2(), I2()) : go(I2(), I1());
      break;
    case 3:
      go(std::integral_constant<int, 3>(), I1());
      break;
    case 4:
      qw == 4 ? go(I4(), I4()) : qw == 2 ? go(I4(), I2()) : go(I4(), I1());
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kGradF1, bool kWin = false, bool kTP = false>
int launch_col_f1(const int* rows, const float* x, int C, int L,
                  const int* cols, const int* group, const float* e,
                  const float* q, float* ptab, float* v_t, const float* mu,
                  const float* lam, const float* alpha, const float* z,
                  int* nans, float lr, float reg, float n_cases,
                  cudaStream_t stream, float* gacc = nullptr, int win = 0,
                  int64_t D = 0) {
  const int G = f1_lanes(C, L);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(C) * G + kF1Threads - 1) / kF1Threads);
  auto go = [&](auto v) {
    constexpr int kV = decltype(v)::value;
    if constexpr (kWin) {
      col_draw_f1_win_kernel<kV, kTP><<<blocks, kF1Threads, 0, stream>>>(
          rows, x, C, L, G, cols, group, e, q, ptab, v_t, mu, lam, alpha, z,
          nans, lr, reg, n_cases, gacc, win, D);
    } else {
      col_draw_f1_kernel<kGradF1, kV><<<blocks, kF1Threads, 0, stream>>>(
          rows, x, C, L, G, cols, group, e, q, ptab, v_t, mu, lam, alpha, z,
          nans, lr, reg, n_cases);
    }
  };
  switch (f1_vec(rows, x, L, G)) {
    case 4: go(std::integral_constant<int, 4>()); break;
    case 2: go(std::integral_constant<int, 2>()); break;
    default: go(std::integral_constant<int, 1>()); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X8a on one [C, L] bucket of an F-factor block.  Writes v_t [D, F] at the
// bucket's columns and ptab's dv channels (F..2F-1 of [D, 2F]); reads the
// pre-bin v from ptab's channels 0..F-1; nans[0], nans[1] += the NaN, Inf
// draws.  exact = 0 is factor-Jacobi; z (the [F, D] noise table) nullptr
// draws the mean (ALS).  The form (mirrored by kernels/mcmc_sweep.py:
// col_draw_form): F = 1 lanes over a column's slots; the exact mode at
// 2 <= F <= 4 the lanes form; else a block a column.
SVBFM_EXPORT int svbfm_mcmc_col_draw(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* e, const float* q, int F, float* ptab,
    float* v_t, const float* mu, const float* lam, const float* alpha,
    const float* z, int64_t D, int exact, int* nans, cudaStream_t stream) {
  if (F == 1)
    return launch_col_f1<false>(rows, x, C, L, cols, group, e, q, ptab, v_t,
                                mu, lam, alpha, z, nans, 0.f, 0.f, 1.f,
                                stream);
  if (!exact)
    return launch_col_draw<kJacobi, 1>(rows, x, C, L, cols, group, e, q, F,
                                       ptab, v_t, mu, lam, alpha, z, D, nans,
                                       0.f, 0.f, 1.f, stream);
  if (F <= kLanesMaxF)
    return launch_col_lanes<false>(rows, x, C, L, cols, group, e, q, F, ptab,
                                   v_t, mu, lam, alpha, z, D, nans, stream);
  return svbfm::with_draw_slots(F, [&](auto slots) {
    return launch_col_draw<kExact, decltype(slots)::value>(
        rows, x, C, L, cols, group, e, q, F, ptab, v_t, mu, lam, alpha, z, D,
        nans, 0.f, 0.f, 1.f, stream);
  });
}

// X14a: X8a's exact draw on one window's [C, L] view of a bucket, its rows
// local to the window's caches e [Wlen], q [Wlen, F].  The window's sums
// (s0 | sh2 | M packed, 2F + F(F-1)/2 a column) go into acc [C, ...] in
// window order, win bit 0 marking the first window and bit 1 the last,
// whose launch also draws from the accumulated sums and writes v_t, ptab's
// dv channels and nans as svbfm_mcmc_col_draw does, in its form.
SVBFM_EXPORT int svbfm_mcmc_col_draw_window(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* e, const float* q, int F, float* ptab,
    float* v_t, const float* mu, const float* lam, const float* alpha,
    const float* z, int64_t D, int* nans, float* acc, int win,
    cudaStream_t stream) {
  if (F == 1)
    return launch_col_f1<false, true>(rows, x, C, L, cols, group, e, q, ptab,
                                      v_t, mu, lam, alpha, z, nans, 0.f, 0.f,
                                      1.f, stream, acc, win);
  if (F <= kLanesMaxF)
    return launch_col_lanes<true>(rows, x, C, L, cols, group, e, q, F, ptab,
                                  v_t, mu, lam, alpha, z, D, nans, stream,
                                  acc, win);
  return svbfm::with_draw_slots(F, [&](auto slots) {
    return launch_col_draw<kExact, decltype(slots)::value, true>(
        rows, x, C, L, cols, group, e, q, F, ptab, v_t, mu, lam, alpha, z, D,
        nans, 0.f, 0.f, 1.f, stream, acc, win);
  });
}

// X8a's gradient mode (X9d) on one [C, L] bucket: v_t [D, F] and ptab's dv
// channels at the bucket's columns, v' = keep_finite(v - lr (sum h e +
// reg v) / n_cases, v), from the pre-bin v in ptab's channels 0..F-1.
SVBFM_EXPORT int svbfm_mcmc_col_grad(
    const int* rows, const float* x, int C, int L, const int* cols,
    const float* e, const float* q, int F, float* ptab, float* v_t,
    float lr, float reg, float n_cases, cudaStream_t stream) {
  if (F == 1)
    return launch_col_f1<true>(rows, x, C, L, cols, nullptr, e, q, ptab,
                               v_t, nullptr, nullptr, nullptr, nullptr,
                               nullptr, lr, reg, n_cases, stream);
  return launch_col_draw<kGrad, 1>(rows, x, C, L, cols, nullptr, e, q, F,
                                   ptab, v_t, nullptr, nullptr, nullptr,
                                   nullptr, 0, nullptr, lr, reg, n_cases,
                                   stream);
}

// X8b: patch q [N, F] and e [N] in place from ptab [D, 2F] = (v_old, dv):
// a thread a row at F = 1, else the wide form with V = 4, 2 or 1 factors a
// chunk as F and the bases of q and ptab allow, min(F / V, 32) lanes a row
// (mirrored by kernels/mcmc_sweep.py:patch_plan).
SVBFM_EXPORT int svbfm_mcmc_patch_rows(const float* ptab, int F,
                                       const int* ids, const float* vals,
                                       int64_t N, int P, float* q, float* e,
                                       cudaStream_t stream) {
  if (F == 1) {
    const unsigned blocks =
        static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
    row_patch_f1_kernel<<<blocks, kPatchThreads, 0, stream>>>(
        ptab, ids, vals, N, P, q, e, 0, 0, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const int V = chunk_width(F, q, ptab);
  const int TPR = std::min(F / V, 32);
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks = static_cast<unsigned>(
      (warps * 32 + kPatchThreads - 1) / kPatchThreads);
  auto go = [&](auto v) {
    constexpr int kV = decltype(v)::value;
    auto kernel = P == 2 ? row_patch_wide_kernel<kV, 2>
                         : row_patch_wide_kernel<kV, 0>;
    kernel<<<blocks, kPatchThreads, 0, stream>>>(ptab, F, ids, vals, N, P,
                                                 TPR, q, e, 0, 0, nullptr);
  };
  if (V == 4) {
    go(std::integral_constant<int, 4>());
  } else if (V == 2) {
    go(std::integral_constant<int, 2>());
  } else {
    go(std::integral_constant<int, 1>());
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// T7's two launches (see svbfm_tp_col_draw_stats and svbfm_tp_col_draw): X14a's
// first window that is not the last (win 1), or its last that is not the
// first on a bucket of no slots (win 2, L = 0: no row read), in X14a's form
// for F and the mode.
int tp_col_draw_launch(const int* rows, const float* x, int C, int L,
                       const int* cols, const int* group, const float* e,
                       const float* q, int F, float* ptab, float* v_t,
                       const float* mu, const float* lam, const float* alpha,
                       const float* z, int64_t D_loc, int exact, int* nans,
                       float* acc, int win, cudaStream_t stream) {
  if (C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  if (F == 1)
    return launch_col_f1<false, true, true>(rows, x, C, L, cols, group, e, q,
                                            ptab, v_t, mu, lam, alpha, z,
                                            nans, 0.f, 0.f, 1.f, stream, acc,
                                            win, D_loc);
  if (!exact)
    return launch_col_draw<kJacobi, 1, true, true>(
        rows, x, C, L, cols, group, e, q, F, ptab, v_t, mu, lam, alpha, z,
        D_loc, nans, 0.f, 0.f, 1.f, stream, acc, win);
  if (F <= kLanesMaxF)
    return launch_col_lanes<true, true>(rows, x, C, L, cols, group, e, q, F,
                                        ptab, v_t, mu, lam, alpha, z, D_loc,
                                        nans, stream, acc, win);
  return svbfm::with_draw_slots(F, [&](auto slots) {
    return launch_col_draw<kExact, decltype(slots)::value, true, true>(
        rows, x, C, L, cols, group, e, q, F, ptab, v_t, mu, lam, alpha, z,
        D_loc, nans, 0.f, 0.f, 1.f, stream, acc, win);
  });
}

}  // namespace

// T7 (svbfm_tpu/parallel/tp_mcmc.py:239-283), X14a's window modes on one
// [C, L] bucket of a feature shard of the Gibbs/ALS v sweep, cols local ids
// of the shard's D_loc columns (padding: D_loc, skipped: neither read nor
// written).  The stats launch: the bucket's sums over this data shard's rows
// (e [N], q [N, F]; the pre-bin v from ptab [D_loc, 2F]'s channels 0..F-1)
// go into acc [C, nout], nout = 2F + F(F-1)/2 (s0 | sh2 | M packed), or 2F
// (s0 | sh2) where exact = 0; the caller all-reduces acc over the data
// shards.  X14a's forms: F = 1 lanes over a column's slots, the exact mode
// at 2 <= F <= 4 the lanes form, else a block a column.
SVBFM_EXPORT int svbfm_tp_col_draw_stats(const int* rows, const float* x,
                                         int C, int L, const int* cols,
                                         const float* e, const float* q,
                                         int F, float* ptab, int64_t D_loc,
                                         int exact, float* acc,
                                         cudaStream_t stream) {
  return tp_col_draw_launch(rows, x, C, L, cols, nullptr, e, q, F, ptab,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            D_loc, exact, nullptr, acc, 1, stream);
}

// T7's draw launch: no row read; the bucket's columns drawn from acc [C,
// nout] (the data shards' sums) as svbfm_mcmc_col_draw draws them, exactly
// or factor-Jacobi where exact = 0, into v_t [D_loc, F], ptab's dv channels
// and nans; mu/lam [G, F] the group priors, z the [F, D_loc] noise table at
// the shard's columns (nullptr: ALS).
SVBFM_EXPORT int svbfm_tp_col_draw(const int* rows, const float* x, int C,
                                   const int* cols, const int* group, int F,
                                   float* ptab, float* v_t, const float* mu,
                                   const float* lam, const float* alpha,
                                   const float* z, int64_t D_loc, int exact,
                                   int* nans, float* acc,
                                   cudaStream_t stream) {
  return tp_col_draw_launch(rows, x, C, 0, cols, group, nullptr, nullptr, F,
                            ptab, v_t, mu, lam, alpha, z, D_loc, exact, nans,
                            acc, 2, stream);
}

// T8 (svbfm_tpu/parallel/tp_mcmc.py:284-301): X8b's delta mode.  out
// [N (F + 1)] = dq [N, F] = sum_p x dv, then de [N] = sum_p sum_f
// x (q - x v_old) dv, over the positions whose ids lie in the feature
// shard [lo, lo + D_loc), against the pre-patch q [N, F]; ptab [D_loc, 2F]
// = (v_old, dv) at local ids.  Not applied: the caller all-reduces out
// over the feature shards, then q -= dq and e -= de.  X8b's forms.
SVBFM_EXPORT int svbfm_tp_mcmc_patch_delta(const float* ptab, int F,
                                           int64_t lo, int D_loc,
                                           const int* ids, const float* vals,
                                           int64_t N, int P, const float* q,
                                           float* out, cudaStream_t stream) {
  float* qm = const_cast<float*>(q);  // read, never written, in this mode
  if (F == 1) {
    const unsigned blocks =
        static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
    row_patch_f1_kernel<true><<<blocks, kPatchThreads, 0, stream>>>(
        ptab, ids, vals, N, P, qm, nullptr, lo, D_loc, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int V = chunk_width(F, q, ptab, out);
  const int TPR = std::min(F / V, 32);
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks = static_cast<unsigned>(
      (warps * 32 + kPatchThreads - 1) / kPatchThreads);
  auto go = [&](auto v) {
    constexpr int kV = decltype(v)::value;
    auto kernel = P == 2 ? row_patch_wide_kernel<kV, 2, true>
                         : row_patch_wide_kernel<kV, 0, true>;
    kernel<<<blocks, kPatchThreads, 0, stream>>>(
        ptab, F, ids, vals, N, P, TPR, qm, nullptr, lo, D_loc, out);
  };
  if (V == 4) {
    go(std::integral_constant<int, 4>());
  } else if (V == 2) {
    go(std::integral_constant<int, 2>());
  } else {
    go(std::integral_constant<int, 1>());
  }
  return static_cast<int>(cudaGetLastError());
}
