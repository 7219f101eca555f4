// X10a-X10c: the relation sweeps of the native block-structure (BS)
// Gibbs/ALS sampler, libFM's VLDB'13 path: the relations stay factored and
// the join is never materialised.
//
// Replaces the XLA gather chains of svbfm_tpu/learners/mcmc_bs.py:
//   X10a _join_aggregate (:554) + _scatter_agg (:567) and the channel
//        builds (:320-331 blocked, :753-757 factor-sequential, :644-646 w):
//        per relation row rho, the sums over the data rows n joined to rho
//        of x times the channels built from e [N] and qO = q - qB0[rho]:
//          e | e qO_f | qO_f | qO_f qO_g (f <= g, numpy triu order)
//        (1 + 2F + F(F+1)/2 channels; F = 1: e, e qO, qO, qO^2; F = 0,
//        the w sweep: e alone).
//   X10b the relation bucket (:379-438 blocked, :771-797 F = 1, :650-669
//        w): per relation attribute c of a [C, L] bucket over relation rows
//        rho, with h_f = x (qB_f - x v_f) (w mode: h = x):
//          she_f = sum h_f we + x weq_f
//          sh2_f = sum h_f^2 wn + 2 wc_f x h_f + x^2 wcc_ff
//          M_fg  = sum h_f h_g wn + h_f x wc_g + x h_g wc_f + x^2 wcc_fg
//        then the exact sequential draw of the F factors through M
//        (svbfm::sequential_draws, the code X8a runs).
//   X10c the relation-row patch after a bin (:439-453, :798-810, :670-676),
//        over the row-layout positions that hold the bin's columns
//        (patch_pos): with h from the pre-patch qB of the row,
//          s1 = sum_g dv_g h_g
//          we    -= s1 wn + x sum_g dv_g wc_g
//          weq_f -= s1 wc_f + x sum_g dv_g wcc_gf
//          dy_f  -= dv_f h_f,   qB_f -= x dv_f
//        (F = 1 in the reference's grouping, the w mode we -= x dv wn,
//        dy -= x dv).
//
// Layouts.  The relation-row table rtab [R, 3F + 2 + P] (P = F(F+1)/2) is
// JAX's per-bin channel stack, row-major: qB [F] | we | weq [F] | wc [F] |
// wcc [P] | wn; the w sweep's is [R, 2] = we | wn (the same layout at
// F = 0).  X10a writes channels F .. 3F + P of it from the qB0 in channels
// 0 .. F-1; X10c patches qB, we and weq in place.  The patch table ptab
// [Dr, 2Fo] = (v_old, dv = v_old - v_new), Fo = max(F, 1), and the factor
// table v_t [Dr, Fo] are X8a's.  Group priors mu/lam [G, Fo]; the noise table
// z [Fo, Dr] (nullptr for ALS).
//
// Bound: bytes.  X10a reads the bucket's rows and x, e and q at each joined
// data row (1 + F floats at a data-dependent address) and writes
// [R, 1 + 2F + P] (251 channels at F = 20, 4 at F = 1, 1 at F = 0); its
// products are formed in registers and shared memory, never as JAX's
// [CH, N] stack (1 GB at 1M rows).  X10b gathers the row's
// 3F + 2 + P channels (about 1 KB at F = 20) per entry; X10c reads wcc
// ([R, 210] at F = 20) for the weq matvec in every bin.
//
// Design.  X10a runs a whole join plan in one launch: its buckets' blocks
// are laid end to end, and each block finds its bucket in the plan table
// (kPlanCols int64 a bucket, built once per plan by the wrapper), so a
// relation pays one launch, not one a bucket.  Two forms, chosen by F.
// F >= 2 (1 + 2F + P channels): one block per relation row; the block
// stages a tile of kTile entries of e and qO in shared memory, and each
// thread owns some of the channel sums (X8a's pattern).  F <= 1 (1 or 4
// channels, the relation w sweep and the factor-sequential path), where a
// block a row would leave all but one thread idle: G lanes a relation row, G the next power of two >= L capped at 32, many
// rows a block; the lanes stride over the row's entries (coalesced reads
// of rows and x), keep the channel sums in registers and end with a
// butterfly of __shfl_xor_sync over the G lanes: no shared memory, no
// barrier, and a fixed order of the sums, so the result is deterministic.
// In both a padding entry (x = 0) adds nothing and gathers no e or q.
// X10b: one block per (column, split).  The attribute-slot bins of a
// relation hold two columns of tens of thousands of entries each, so a
// column's entries are split over S blocks; each writes its partial sums,
// and the last block to finish a column (a done-counter, as X9c) adds the
// S partials in a fixed order (deterministic) and draws.  The she/sh2/M
// sums are owner-written in shared memory as in X8a; wcc is read by the
// owner threads straight from rtab (neighbouring threads, neighbouring
// addresses).  X10c: one warp per relation row, lanes over factors.
#include "mcmc_draw.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kNarrowThreads = 256;  // X10a at F <= 1
// X10a's plan table, int64 [nb, kPlanCols], a row a bucket of the join
// plan: rows, x and cols pointers, C, L, G (the F <= 1 form's lanes a
// relation row) and the bucket's first block (mirrored by
// kernels/bs_sweep.py:join_plan_rows)
constexpr int kPlanCols = 7;

struct Bucket {
  const int* rows;   // [C, L]
  const float* x;    // [C, L]
  const int* cols;   // [C]
  int C, L, G;
  int64_t first;     // the bucket's first block
};

// The bucket whose blocks hold this block: the last one whose first block
// is <= blockIdx.x (a bucket with no blocks shares its first block with
// the next, so it is stepped over).
__device__ inline Bucket find_bucket(const int64_t* __restrict__ plan,
                                     int nb) {
  int b = 0;
  while (b + 1 < nb && plan[(b + 1) * kPlanCols + 6] <= blockIdx.x) ++b;
  const int64_t* p = plan + b * kPlanCols;
  return Bucket{reinterpret_cast<const int*>(p[0]),
                reinterpret_cast<const float*>(p[1]),
                reinterpret_cast<const int*>(p[2]), static_cast<int>(p[3]),
                static_cast<int>(p[4]), static_cast<int>(p[5]), p[6]};
}

// Channel offsets of rtab for F factors (F = 0: the w sweep's table).
struct RelLayout {
  int F, P, we, weq, wc, wcc, wn, ld;
  __host__ __device__ explicit RelLayout(int f)
      : F(f), P(f * (f + 1) / 2), we(f), weq(f + 1), wc(2 * f + 1),
        wcc(3 * f + 1), wn(3 * f + 1 + f * (f + 1) / 2),
        ld(3 * f + 2 + f * (f + 1) / 2) {}
  // offset of wcc_fg, f <= g, in the packed upper triangle with diagonal
  __device__ int wcc_at(int f, int g) const {
    return wcc + svbfm::pair_index(f, g + 1, F + 1);
  }
};

__host__ __device__ inline int agg_channels(int F) {
  return 1 + 2 * F + F * (F + 1) / 2;
}

// X10a at F >= 2: one block per relation row (a column of one of the join
// plan's buckets).
__global__ void join_agg_kernel(const int64_t* __restrict__ plan, int nb,
                                const float* __restrict__ e,
                                const float* __restrict__ q, int F,
                                float* __restrict__ rtab) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Bucket bk = find_bucket(plan, nb);
  const int64_t c = blockIdx.x - bk.first;
  const int L = bk.L;
  const RelLayout lay(F);
  const int CH = agg_channels(F);
  const int ldt = kTile + 1;
  float* acc = smem;          // [CH]
  float* es = acc + CH;       // [kTile] e x
  float* xs = es + kTile;     // [kTile]
  float* qs = xs + kTile;     // [F, kTile + 1] qO
  float* qb = qs + F * ldt;   // [F] qB0 of the row
  const int64_t rho = bk.cols[c];
  for (int f = tid; f < F; f += nt) qb[f] = rtab[rho * lay.ld + f];
  for (int o = tid; o < CH; o += nt) acc[o] = 0.f;
  __syncthreads();
  const int* crow = bk.rows + c * L;
  const float* cx = bk.x + c * L;
  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int nl = min(kTile, L - l0);
    for (int i = tid; i < kTile * F; i += nt) {
      const int l = i / F;
      const int f = i - l * F;
      const float xv = l < nl ? cx[l0 + l] : 0.f;
      const int64_t r = xv != 0.f ? crow[l0 + l] : -1;
      qs[f * ldt + l] = r >= 0 ? q[r * F + f] - qb[f] : 0.f;
      if (f == 0) {
        xs[l] = xv;
        es[l] = r >= 0 ? e[r] : 0.f;
      }
    }
    __syncthreads();
    for (int o = tid; o < CH; o += nt) {
      float s = 0.f;
      if (o == 0) {
        for (int l = 0; l < kTile; ++l) s += es[l] * xs[l];
      } else if (o <= F) {
        const float* qf = qs + (o - 1) * ldt;
        for (int l = 0; l < kTile; ++l) s += es[l] * qf[l] * xs[l];
      } else if (o <= 2 * F) {
        const float* qf = qs + (o - 1 - F) * ldt;
        for (int l = 0; l < kTile; ++l) s += qf[l] * xs[l];
      } else {
        const int fg = svbfm::pair_at(o - 1 - 2 * F, F + 1);
        const float* qf = qs + (fg >> 16) * ldt;
        const float* qg = qs + ((fg & 0xffff) - 1) * ldt;
        for (int l = 0; l < kTile; ++l) s += qf[l] * qg[l] * xs[l];
      }
      acc[o] += s;
    }
    __syncthreads();
  }
  for (int o = tid; o < CH; o += nt) rtab[rho * lay.ld + F + o] = acc[o];
}

// X10a at F <= 1 (kCH = 1: e; kCH = 4: e, e qO, qO, qO^2 with qO = q - qB0):
// G lanes per relation row (a column c of a bucket), G a power of two
// <= 32, so a row's lanes sit in one warp.  No thread leaves early: every
// lane of a warp takes part in the shuffles.
template <int kCH>
__global__ void join_agg_narrow_kernel(const int64_t* __restrict__ plan,
                                       int nb, const float* __restrict__ e,
                                       const float* __restrict__ q,
                                       float* __restrict__ rtab, int ld) {
  constexpr int F = kCH == 4 ? 1 : 0;
  const Bucket bk = find_bucket(plan, nb);
  const int G = bk.G, L = bk.L;
  const int64_t c =
      ((blockIdx.x - bk.first) * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & (G - 1);
  const bool live = c < bk.C;
  float s[kCH];
#pragma unroll
  for (int i = 0; i < kCH; ++i) s[i] = 0.f;
  int64_t rho = 0;
  if (live) {
    rho = bk.cols[c];
    const float qb = kCH == 4 ? rtab[rho * ld] : 0.f;
    const int* __restrict__ crow = bk.rows + c * L;
    const float* __restrict__ cx = bk.x + c * L;
#pragma unroll 4
    for (int l = lane; l < L; l += G) {
      // the row id is read beside x, from sectors the lanes read anyway,
      // so that the gather waits on one load, not two
      const float xv = cx[l];
      const int64_t r = crow[l];
      if (xv == 0.f) continue;  // a padding entry gathers nothing
      const float ev = e[r];
      s[0] += ev * xv;
      if constexpr (kCH == 4) {
        const float qo = q[r] - qb;
        s[1] += ev * qo * xv;
        s[2] += qo * xv;
        s[3] += qo * qo * xv;
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kCH; ++i)
      s[i] += __shfl_xor_sync(svbfm::kFullMask, s[i], o);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int i = 0; i < kCH; ++i) rtab[rho * ld + F + i] = s[i];
  }
}

// Sums a relation column owns: she [Fo], sh2 [Fo], then the packed M.
__host__ __device__ inline int draw_outputs(int F) {
  const int Fo = F > 1 ? F : 1;
  return 2 * Fo + (F > 1 ? F * (F - 1) / 2 : 0);
}

// X10b: one block per (column, split).  kW: the w mode (F = 0, h = x).
template <bool kW>
__global__ void rel_draw_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L, int Ls,
    int S, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ rtab, int F, float* __restrict__ ptab,
    float* __restrict__ v_t, const float* __restrict__ mu,
    const float* __restrict__ lam, const float* __restrict__ alpha_p,
    const float* __restrict__ z, int64_t Dr, int* __restrict__ nans,
    float* __restrict__ part, int* __restrict__ done) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = blockIdx.x;
  const int s_i = blockIdx.y;
  const RelLayout lay(F);
  const int Fo = max(F, 1);
  const int nout = draw_outputs(F);
  const int ldt = kTile + 1;
  float* acc = smem;                // [nout]: she | sh2 | M (packed)
  float* hs = acc + nout;           // [Fo, kTile + 1]
  float* xs = hs + Fo * ldt;        // [kTile]
  float* ws = xs + kTile;           // [kTile] we
  float* ns = ws + kTile;           // [kTile] wn
  float* wqs = ns + kTile;          // [F, kTile + 1] weq
  float* wcs = wqs + F * ldt;       // [F, kTile + 1] wc
  int* rs = reinterpret_cast<int*>(wcs + F * ldt);  // [kTile] rho
  float* vc = reinterpret_cast<float*>(rs + kTile);  // [Fo] pre-bin v
  float* corr = vc + Fo;            // [Fo]
  float* prior = corr + Fo;         // [3, Fo]: mu, lambda, z
  float* dsh = prior + 3 * Fo;      // [1]
  float* last = dsh + 1;            // [1]: this block adds the partials

  const int64_t col = cols[c];
  const int64_t ldp = 2 * Fo;
  const int g_c = group[c];
  for (int f = tid; f < Fo; f += nt) {
    vc[f] = ptab[col * ldp + f];
    corr[f] = 0.f;
    prior[f] = mu[g_c * Fo + f];
    prior[Fo + f] = lam[g_c * Fo + f];
    prior[2 * Fo + f] = z != nullptr ? z[f * Dr + col] : 0.f;
  }
  for (int o = tid; o < nout; o += nt) acc[o] = 0.f;
  __syncthreads();

  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  const int l_end = min(L, (s_i + 1) * Ls);
  for (int l0 = s_i * Ls; l0 < l_end; l0 += kTile) {
    const int nl = min(kTile, l_end - l0);
    for (int i = tid; i < kTile * Fo; i += nt) {
      const int l = i / Fo;
      const int f = i - l * Fo;
      const float xv = l < nl ? cx[l0 + l] : 0.f;
      const int64_t r = xv != 0.f ? crow[l0 + l] : -1;
      const float* g = rtab + (r >= 0 ? r : 0) * lay.ld;
      float h = 0.f;
      if (r >= 0) h = kW ? xv : xv * (g[f] - xv * vc[f]);
      hs[f * ldt + l] = h;
      if (!kW) {
        wqs[f * ldt + l] = r >= 0 ? g[lay.weq + f] : 0.f;
        wcs[f * ldt + l] = r >= 0 ? g[lay.wc + f] : 0.f;
      }
      if (f == 0) {
        xs[l] = xv;
        ws[l] = r >= 0 ? g[lay.we] : 0.f;
        ns[l] = r >= 0 ? g[lay.wn] : 0.f;
        rs[l] = static_cast<int>(r);
      }
    }
    __syncthreads();
    for (int o = tid; o < nout; o += nt) {
      float s = 0.f;
      if (o < Fo) {
        const float* hf = hs + o * ldt;
        if (kW) {
          for (int l = 0; l < kTile; ++l) s += hf[l] * ws[l];
        } else {
          const float* qf = wqs + o * ldt;
          for (int l = 0; l < kTile; ++l) s += hf[l] * ws[l] + xs[l] * qf[l];
        }
      } else if (o < 2 * Fo) {
        const int f = o - Fo;
        const float* hf = hs + f * ldt;
        if (kW) {
          for (int l = 0; l < kTile; ++l) s += hf[l] * hf[l] * ns[l];
        } else {
          const float* cf = wcs + f * ldt;
          const int off = lay.wcc_at(f, f);
          for (int l = 0; l < kTile; ++l) {
            if (rs[l] < 0) continue;
            const float xv = xs[l];
            s += hf[l] * hf[l] * ns[l] + 2.f * cf[l] * xv * hf[l]
                 + xv * xv * rtab[static_cast<int64_t>(rs[l]) * lay.ld + off];
          }
        }
      } else {
        const int fg = svbfm::pair_at(o - 2 * Fo, F);
        const int f = fg >> 16, g = fg & 0xffff;
        const float* hf = hs + f * ldt;
        const float* hg = hs + g * ldt;
        const float* cf = wcs + f * ldt;
        const float* cg = wcs + g * ldt;
        const int off = lay.wcc_at(f, g);
        for (int l = 0; l < kTile; ++l) {
          if (rs[l] < 0) continue;
          const float xv = xs[l];
          s += hf[l] * hg[l] * ns[l] + hf[l] * xv * cg[l] + xv * hg[l] * cf[l]
               + xv * xv * rtab[static_cast<int64_t>(rs[l]) * lay.ld + off];
        }
      }
      acc[o] += s;
    }
    __syncthreads();
  }

  if (S > 1) {  // the last block of the column adds the partials
    float* mine = part + (static_cast<int64_t>(c) * S + s_i) * nout;
    for (int o = tid; o < nout; o += nt) mine[o] = acc[o];
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(&done[c], 1) == S - 1 ? 1.f : 0.f;
    __syncthreads();
    if (*last == 0.f) return;  // the whole block leaves together
    __threadfence();
    const float* all = part + static_cast<int64_t>(c) * S * nout;
    for (int o = tid; o < nout; o += nt) {
      float t = 0.f;
      for (int k = 0; k < S; ++k) t += __ldcg(all + k * nout + o);
      acc[o] = t;
    }
    if (tid == 0) done[c] = 0;  // ready for the next launch
    __syncthreads();
  }
  int nan_c = 0, inf_c = 0;
  svbfm::sequential_draws(acc, Fo, vc, corr, prior, *alpha_p, z != nullptr,
                          dsh, v_t + col * Fo, ptab + col * ldp + Fo, nan_c,
                          inf_c);
  if (nan_c) atomicAdd(&nans[0], nan_c);
  if (inf_c) atomicAdd(&nans[1], inf_c);
}

// X10c: one warp per relation row, the positions in order.
__global__ void rel_patch_kernel(const int* __restrict__ rids,
                                 const float* __restrict__ rvals, int64_t R,
                                 int Pr, const int* __restrict__ pos,
                                 int npos, const float* __restrict__ ptab,
                                 int F, float* __restrict__ rtab,
                                 float* __restrict__ dy) {
  const int lane = threadIdx.x & 31;
  const int64_t rho =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (rho >= R) return;  // the whole warp leaves together
  const RelLayout lay(F);
  const int Fo = max(F, 1);
  float* row = rtab + rho * lay.ld;
  float* dyr = dy + rho * Fo;
  for (int k = 0; k < npos; ++k) {
    const int p = pos[k];
    const int64_t id = rids[rho * Pr + p];
    const float xp = rvals[rho * Pr + p];
    const float* g = ptab + id * 2 * Fo;
    if (F == 0) {  // mcmc_bs.py:672-676
      if (lane == 0) {
        const float dv = g[1];
        row[lay.we] -= xp * dv * row[lay.wn];
        dyr[0] -= xp * dv;
      }
      continue;
    }
    if (F == 1) {  // mcmc_bs.py:802-810
      if (lane == 0) {
        const float dv = g[1];
        const float h = xp * (row[0] - xp * g[0]);
        const float wn = row[lay.wn], wc = row[lay.wc];
        row[lay.we] -= dv * (h * wn + xp * wc);
        row[lay.weq] -= dv * (h * wc + xp * row[lay.wcc]);
        dyr[0] -= dv * h;
        row[0] -= xp * dv;
      }
      continue;
    }
    // mcmc_bs.py:442-453
    float s1 = 0.f, t = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float dv = g[F + f];
      s1 += dv * (xp * (row[f] - xp * g[f]));
      t += dv * row[lay.wc + f];
    }
    s1 = svbfm::warp_sum(s1);
    t = svbfm::warp_sum(t);
    for (int f = lane; f < F; f += 32) {
      float m = 0.f;
      for (int gi = 0; gi < F; ++gi)
        m += g[F + gi] * row[gi <= f ? lay.wcc_at(gi, f) : lay.wcc_at(f, gi)];
      const float dv = g[F + f];
      const float h = xp * (row[f] - xp * g[f]);
      row[lay.weq + f] -= s1 * row[lay.wc + f] + xp * m;
      dyr[f] -= dv * h;
      row[f] -= xp * dv;
    }
    __syncwarp();
    if (lane == 0) row[lay.we] -= s1 * row[lay.wn] + xp * t;
    __syncwarp();
  }
}

}  // namespace

// Mirrored by kernels/bs_sweep.py:join_agg_smem and rel_draw_smem.
static size_t join_agg_smem(int F) {
  return sizeof(float) * (agg_channels(F) + 2 * kTile + F * (kTile + 1) + F);
}

static size_t rel_draw_smem(int F) {
  const int Fo = F > 1 ? F : 1;
  return sizeof(float) * (draw_outputs(F) + Fo * (kTile + 1) + 3 * kTile +
                          2 * F * (kTile + 1) + kTile + 5 * Fo + 2);
}

static int block_threads(int n) { return n > 128 ? 256 : (n > 32 ? 128 : 64); }

// X10a over the nb buckets of a join plan (each [C, L]; rows: data rows,
// cols: relation rows): writes rtab [R, 3F + 2 + P] channels F .. 3F + P
// (F = 0: rtab [R, 2], channel 0) at the buckets' relation rows.  plan is
// the device table [nb, kPlanCols], blocks the buckets' blocks in all: C
// a bucket at F >= 2, ceil(C G / kNarrowThreads) at F <= 1.
SVBFM_EXPORT int svbfm_bs_join_agg(const int64_t* plan, int nb,
                                   int64_t blocks, const float* e,
                                   const float* q, int F, float* rtab,
                                   cudaStream_t stream) {
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (F <= 1) {
    const int ld = RelLayout(F).ld;
    if (F == 0) {
      join_agg_narrow_kernel<1><<<grid, kNarrowThreads, 0, stream>>>(
          plan, nb, e, q, rtab, ld);
    } else {
      join_agg_narrow_kernel<4><<<grid, kNarrowThreads, 0, stream>>>(
          plan, nb, e, q, rtab, ld);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = join_agg_smem(F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        join_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  join_agg_kernel<<<grid, block_threads(agg_channels(F)), smem, stream>>>(
      plan, nb, e, q, F, rtab);
  return static_cast<int>(cudaGetLastError());
}

// X10b on one [C, L] bucket of a relation bin (rows: relation rows; cols:
// relation attributes), F factors (F = 0: the w draw).  Each column's
// entries are split into S runs of Ls; with S > 1, part [C, S, nout] is
// scratch and done [C] zeroed counters (left zeroed).  Writes v_t [Dr, Fo]
// and ptab's dv channels at the bucket's columns; nans += NaN, Inf draws.
SVBFM_EXPORT int svbfm_bs_rel_draw(
    const int* rows, const float* x, int C, int L, int Ls, int S,
    const int* cols, const int* group, const float* rtab, int F, float* ptab,
    float* v_t, const float* mu, const float* lam, const float* alpha,
    const float* z, int64_t Dr, int* nans, float* part, int* done,
    cudaStream_t stream) {
  const size_t smem = rel_draw_smem(F);
  const int threads = block_threads(draw_outputs(F));
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>(S));
  if (F == 0) {
    rel_draw_kernel<true><<<grid, threads, smem, stream>>>(
        rows, x, L, Ls, S, cols, group, rtab, F, ptab, v_t, mu, lam, alpha, z,
        Dr, nans, part, done);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rel_draw_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rel_draw_kernel<false><<<grid, threads, smem, stream>>>(
      rows, x, L, Ls, S, cols, group, rtab, F, ptab, v_t, mu, lam, alpha, z,
      Dr, nans, part, done);
  return static_cast<int>(cudaGetLastError());
}

// X10c: patch rtab's qB, we, weq (F = 0: we) and dy [R, Fo] in place over
// the row-layout positions pos [npos] of rids/rvals [R, Pr], from ptab
// [Dr, 2Fo] = (v_old, dv).
SVBFM_EXPORT int svbfm_bs_rel_patch(const int* rids, const float* rvals,
                                    int64_t R, int Pr, const int* pos,
                                    int npos, const float* ptab, int F,
                                    float* rtab, float* dy,
                                    cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rel_patch_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      rids, rvals, R, Pr, pos, npos, ptab, F, rtab, dy);
  return static_cast<int>(cudaGetLastError());
}

// X10b's w mode (mcmc_bs.py:650-669): the F = 0 layout rtab [R, 2] =
// (we, wn); w [Dr] and ptab [Dr, 2] = (w_old, dw) as v_t and ptab at Fo = 1;
// mu/lam [G] the w group priors; z [Dr] or nullptr.
SVBFM_EXPORT int svbfm_bs_rel_w_draw(
    const int* rows, const float* x, int C, int L, int Ls, int S,
    const int* cols, const int* group, const float* rtab, float* ptab,
    float* w, const float* mu, const float* lam, const float* alpha,
    const float* z, int64_t Dr, int* bad, float* part, int* done,
    cudaStream_t stream) {
  return svbfm_bs_rel_draw(rows, x, C, L, Ls, S, cols, group, rtab, 0, ptab,
                           w, mu, lam, alpha, z, Dr, bad, part, done, stream);
}

// X10c's w mode (mcmc_bs.py:672-676): we -= x dw wn, dy -= x dw.
SVBFM_EXPORT int svbfm_bs_rel_w_patch(const int* rids, const float* rvals,
                                      int64_t R, int Pr, const int* pos,
                                      int npos, const float* ptab,
                                      float* rtab, float* dy,
                                      cudaStream_t stream) {
  return svbfm_bs_rel_patch(rids, rvals, R, Pr, pos, npos, ptab, 0, rtab, dy,
                            stream);
}
