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
//
// T9, K6 split in two for the feature-sharded OVB (svbfm_tpu/parallel/
// tp_ovb.py:290-338, the factor-sequential v sweep, so F = 1), the kernel's
// template parameter kPart, K6's body with two seams (after the butterfly,
// and where it sums the entries):
//   kStats: the sums v_mean and v_sig of each column of the bin over this
//   data shard's rows, before the division by cnt, with K6's lanes and
//   order; q and tq come from T2's cache qt [N, 3] = (q | tq | tz), whose
//   row stride kQt is a constant of the build (a stride read at run time
//   cost 5-29 % in a gather loop before).  The bin's sums are one [C_bin, 2]
//   buffer, each bucket's columns at its offset, so that ONE all-reduce over
//   the data shards covers the bin (its buckets are column-disjoint).
//   kBlend: after that all-reduce, K6's ending step from the sums: the
//   division by max(cnt, 1), the blend with rho_v, keep-finite, the four
//   tables, ptab's deltas, tv_add (where given) and the counts.  It reads no
//   rows, so it takes a thread a column: one block of 256 columns, not a
//   warp a column with one lane working.
// Both skip a padding column (local id D_loc): the stats write it zero
// sums, the blend writes nothing.  At a world of one the stats are K6's
// sums, bit for bit.
//
// T13, K6 split the same way at any F, for the data-parallel OVB
// (svbfm_tpu/learners/vb_online.py's psums :531-532 at F > 1 and :660-661
// at F = 1): the kernel's second template parameter kAnyF.  Its launches
// read K2's separate q and tq [N, F] at K6's row stride F; the stats write
// the bin's [C_bin, 2F] sums (v_mean's F, then v_sig's F, before the
// division by cnt) at K6's lanes and order; the blend takes FL lanes a
// column, a lane a factor (FL as K6's), and applies K6's ending step from
// the all-reduced sums.  The padding column rule is T9's (the data-parallel
// learner passes D_loc = D, which no column holds).
#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanCols = 8;
constexpr int kQt = 3;  // T9: the row stride of T2's qt [N, 3] at F = 1

// The kernel's parts: K6 itself, and T9's stats and blend launches.
enum Part { kFused, kStats, kBlend };

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
// where the one before it does, so it is never picked).  T9's launches
// also sum the buckets' columns, for the bucket's first column in the
// bin's sums (col0); its blend launch lays a bucket out a thread a column
// (T13's: FL threads a column).  The whole warp takes part.
template <int kPart = kFused, bool kAnyF = false>
__device__ inline Bucket find_bucket(const int64_t* __restrict__ plan,
                                     int nb, int F, int64_t& first,
                                     int64_t& col0) {
  const int lane = threadIdx.x & 31;
  first = 0;
  col0 = 0;
  for (int base = 0; base < nb; base += 32) {
    const int b = base + lane;
    int64_t p[kPlanCols];
#pragma unroll
    for (int k = 0; k < kPlanCols; ++k)
      p[k] = b < nb ? plan[b * kPlanCols + k] : 0;
    const int64_t nblk =
        b < nb ? (kPart == kBlend
                      ? (kAnyF ? (p[6] * factor_lanes(F) + kThreads - 1) /
                                     kThreads
                               : (p[6] + kThreads - 1) / kThreads)
                      : bucket_blocks(static_cast<int>(p[6]), F,
                                      static_cast<int>(p[7])))
               : 0;
    int64_t end = nblk, cend = p[6];
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t v = __shfl_up_sync(svbfm::kFullMask, end, o);
      if (lane >= o) end += v;
      if constexpr (kPart != kFused) {
        const int64_t w = __shfl_up_sync(svbfm::kFullMask, cend, o);
        if (lane >= o) cend += w;
      }
    }
    const unsigned hit =
        __ballot_sync(svbfm::kFullMask, b < nb && blockIdx.x < first + end);
    if (hit != 0) {
      const int src = __ffs(hit) - 1;
      first += __shfl_sync(svbfm::kFullMask, end - nblk, src);
      if constexpr (kPart != kFused)
        col0 += __shfl_sync(svbfm::kFullMask, cend - p[6], src);
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
    if constexpr (kPart != kFused)
      col0 += __shfl_sync(svbfm::kFullMask, cend, 31);
  }
  return Bucket{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1};
}

// K6 (kFused), or T9's stats or blend launch (sums: the bin's [C_bin, 2],
// D_loc: the padding column's local id; K6 reads neither), or with kAnyF
// T13's (sums [C_bin, 2F]).  The parts share one body; the split ones
// differ from K6 at two seams: after the butterfly the stats launch writes
// its sums and stops, and the blend launch takes its sums from the buffer
// where K6 sums the entries.
template <int kPart = kFused, bool kAnyF = false>
__global__ void __launch_bounds__(kThreads) ovb_col_stats_kernel(
    const int64_t* __restrict__ plan, int nb, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ tq, int F,
    float* __restrict__ ptab, float* __restrict__ mu_t,
    float* __restrict__ sig_t, float* __restrict__ nmu_t,
    float* __restrict__ nsig_t, const float* __restrict__ sv,
    const float* __restrict__ alpha_p, const float* __restrict__ rho_v,
    float* __restrict__ tv_add, int* __restrict__ bad,
    float* __restrict__ sums, int64_t D_loc) {
  // T9 runs at F = 1, its q and tq a row of T2's qt apart; T13 at the
  // block's F, on K2's q and tq
  constexpr bool kTp = kPart != kFused;
  constexpr bool kT9 = kTp && !kAnyF;
  if constexpr (kT9) F = 1;
  const int qs = kT9 ? kQt : F;  // the row stride of q and tq
  int64_t first, col0;
  const Bucket bk = find_bucket<kPart, kAnyF>(plan, nb, F, first, col0);
  const int L = bk.L;
  // U and FL are powers of two: shifts, not divisions (T9's blend: a
  // thread a column; T13's: FL threads a column)
  const int u_shift =
      kPart == kBlend ? (kAnyF ? __ffs(factor_lanes(F)) - 1 : 0)
                      : __ffs(col_lanes(F, L)) - 1;
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
  // the lane has an entry (T9's blend reads no rows)
  const bool has0 = kPart != kBlend && live && sl < L;
  const float alpha = kPart == kStats ? 0.f : *alpha_p;
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
    if constexpr (kPart != kStats) {
      n = bk.cnt[c];
      cc = bk.col_count[c];
      g = bk.group[c];
    }
  }
  if (has0) {  // a padding column's slots hold a real row and x = 0
    r0 = crow[sl];
    x0 = cx[sl];
  }
  // T9 leaves the padding column (local id D_loc) as it is
  const bool real = live && (!kTp || col != D_loc);
  float rho = 0.f, tva = 0.f;
  if constexpr (kPart != kStats) {
    if (real) {
      rho = rho_v[col];
      if (!kTp || tv_add != nullptr) tva = tv_add[col];
    }
  }
  const float e0 = has0 ? e[r0] : 0.f;
  float* prow = ptab + col * 5 * F;
  // every lane runs the same factor chunks, so the shuffles see the whole
  // warp
  for (int f0 = 0; f0 < F; f0 += FL) {
    const int f = f0 + fx;
    const bool on = real && f < F;
    const int64_t o = col * F + f;
    float mu_c = 0.f, sig_c = 0.f, nmu = 0.f, nsig = 0.f, svf = 0.f;
    float q0 = 0.f, tq0 = 0.f;
    if (on) {
      mu_c = prow[f];
      sig_c = prow[F + f];
      if constexpr (kPart != kStats) {
        nmu = nmu_t[o];
        nsig = nsig_t[o];
        svf = sv[g * F + f];
      }
      if (has0) {
        q0 = q[r0 * qs + f];
        tq0 = tq[r0 * qs + f];
      }
    }
    float vm = 0.f, vs = 0.f;
    if constexpr (kPart == kBlend) {  // the sums of every data shard
      if (on) {
        if constexpr (kAnyF) {
          vm = sums[(col0 + c) * 2 * F + f];
          vs = sums[(col0 + c) * 2 * F + F + f];
        } else {
          vm = sums[2 * (col0 + c)];
          vs = sums[2 * (col0 + c) + 1];
        }
      }
    } else if (on && has0) {
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
        const float h = q[r * qs + f] - xv * mu_c;
        const float h1 = tq[r * qs + f] - x2 * sig_c;
        vm += xv * h * (e[r] + xv * mu_c * h);
        vs += x2 * h * h + x2 * h1;
      }
    }
    for (int m = U >> 1; m >= FL; m >>= 1) {
      vm += __shfl_xor_sync(svbfm::kFullMask, vm, m);
      vs += __shfl_xor_sync(svbfm::kFullMask, vs, m);
    }
    if constexpr (kPart == kStats) {
      // this data shard's sums, before the division by cnt (zero at the
      // padding column)
      if constexpr (kAnyF) {
        if (live && sl == 0 && f < F) {
          sums[(col0 + c) * 2 * F + f] = vm;
          sums[(col0 + c) * 2 * F + F + f] = vs;
        }
      } else if (live && sl == 0) {
        sums[2 * (col0 + c)] = vm;
        sums[2 * (col0 + c) + 1] = vs;
      }
      continue;
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
    // a column sits in one bucket; T9's blend counts where tv_add is given
    if (f == 0 && (!kTp || tv_add != nullptr)) tv_add[col] = tva + n;
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
  ovb_col_stats_kernel<kFused><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(plan, nb, e, q, tq, F, ptab, mu_t,
                                           sig_t, nmu_t, nsig_t, sv, alpha,
                                           rho_v, tv_add, bad, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// T9, stats: the sums [C_bin, 2] of one bin's columns (plan as K6's,
// `blocks` the stats launch's from the wrapper: K6's at F = 1) over this
// data shard's rows e [N] and qt [N, 3] = (q | tq | tz), with the pre-bin
// mu/sig in channels 0 and 1 of ptab [D_loc, 5]; a padding column's (local
// id D_loc) sums are zero.
SVBFM_EXPORT int svbfm_tp_ovb_stats(const int64_t* plan, int nb,
                                    int64_t blocks, const float* e,
                                    const float* qt, const float* ptab,
                                    float* sums, int64_t D_loc,
                                    cudaStream_t stream) {
  if (blocks == 0) return 0;
  ovb_col_stats_kernel<kStats><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      plan, nb, e, qt, qt + 1, 1, const_cast<float*>(ptab), nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      sums, D_loc);
  return static_cast<int>(cudaGetLastError());
}

// T9, blend: K6's ending step at one bin's columns from sums [C_bin, 2]
// (summed over the data shards; `blocks`: a thread a column, each
// bucket's ceil(C / 256)): mu/sig/nmu/nsig [D_loc, 1], ptab's delta
// channels, tv_add[col] += cnt (tv_add nullptr: not counted) and bad[4],
// as svbfm_ovb_col_stats_update writes them; padding columns skipped.
SVBFM_EXPORT int svbfm_tp_ovb_blend(const int64_t* plan, int nb,
                                    int64_t blocks, const float* sums,
                                    int64_t D_loc, float* ptab, float* mu_t,
                                    float* sig_t, float* nmu_t, float* nsig_t,
                                    const float* sv, const float* alpha,
                                    const float* rho_v, float* tv_add,
                                    int* bad, cudaStream_t stream) {
  if (blocks == 0) return 0;
  ovb_col_stats_kernel<kBlend><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      plan, nb, nullptr, nullptr, nullptr, 1, ptab, mu_t, sig_t, nmu_t,
      nsig_t, sv, alpha, rho_v, tv_add, bad, const_cast<float*>(sums),
      D_loc);
  return static_cast<int>(cudaGetLastError());
}

// T13, stats: the sums [C_bin, 2F] of one bin's columns (plan as K6's,
// `blocks` K6's at F) over this data shard's rows e [N] and K2's q, tq
// [N, F], with the pre-bin mu/sig in channels 0..2F-1 of ptab [D, 5F];
// a padding column's (id D_loc) sums are zero.
SVBFM_EXPORT int svbfm_dp_ovb_stats(const int64_t* plan, int nb,
                                    int64_t blocks, const float* e,
                                    const float* q, const float* tq, int F,
                                    const float* ptab, float* sums,
                                    int64_t D_loc, cudaStream_t stream) {
  if (blocks == 0) return 0;
  ovb_col_stats_kernel<kStats, true><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
      plan, nb, e, q, tq, F, const_cast<float*>(ptab), nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, sums,
      D_loc);
  return static_cast<int>(cudaGetLastError());
}

// T13, blend: K6's ending step at one bin's columns from sums [C_bin, 2F]
// (summed over the data shards; `blocks`: FL threads a column, each
// bucket's ceil(C FL / 256)): mu/sig/nmu/nsig [D, F], ptab's delta
// channels, tv_add[col] += cnt (tv_add nullptr: not counted) and bad[4],
// as svbfm_ovb_col_stats_update writes them; padding columns skipped.
SVBFM_EXPORT int svbfm_dp_ovb_blend(const int64_t* plan, int nb,
                                    int64_t blocks, const float* sums, int F,
                                    int64_t D_loc, float* ptab, float* mu_t,
                                    float* sig_t, float* nmu_t, float* nsig_t,
                                    const float* sv, const float* alpha,
                                    const float* rho_v, float* tv_add,
                                    int* bad, cudaStream_t stream) {
  if (blocks == 0) return 0;
  ovb_col_stats_kernel<kBlend, true><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
      plan, nb, nullptr, nullptr, nullptr, F, ptab, mu_t, sig_t, nmu_t,
      nsig_t, sv, alpha, rho_v, tv_add, bad, const_cast<float*>(sums),
      D_loc);
  return static_cast<int>(cudaGetLastError());
}
