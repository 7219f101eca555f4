// X9a-X9c: the minibatch step of the SGD family (sgd, sgd_online,
// exp_sgd_stoc, SGDA's theta and lambda steps, BPR's pair step).
//
// Replaces svbfm_tpu/learners/sgd.py:sgd_minibatch_update (:103-156) and
// :sgda_lambda_update (:195-264), and svbfm_tpu/learners/bpr.py:
// bpr_pair_update (:68-113), each an XLA chain of gathers and scatter-adds.
//
// Layouts: the parameter table tab [D, 1+K] = (w | v^T), row-major, and w0
// a device scalar, as kernel K1 reads them; the gradient accumulator acc
// [D, 2+K] = (cnt | gw | gv_1..K) and acc0 [2] = (n_eff, sum mult), both
// zero between batches (X9b zeroes what it reads, so a batch is two
// launches and no memset).
//
// X9a sgd_grad_scatter: one warp per row (per pair in pair mode), lanes over
//   factors, 8 rows a block (16 no faster, 4 and 32 slower).  The warp
//   gathers the row's entries once: ids, x and the table's w and factor
//   values, every load of a chunk of entries issued before the first is
//   used, tab through the read-only path (X9a never writes it); it scores
//   the row from the parameters before the batch, forms the loss
//   multiplier and atomically adds each entry's v-gradients
//   mult*(s_f x - v_f x^2) into acc from the same registers (s_f summed
//   over p in order, as before, so each gradient keeps its bits; gathered
//   again only where P > 4 or K > 32).  Then a lane an entry adds its count
//   and w-gradient mult*x.  n_eff and sum mult are reduced per block by a
//   shuffle and added once a block.  Modes: regression (clamped p - y), the
//   exponential family (p/stdev - y), classification (y (sigmoid(y p) - 1))
//   and Poisson (exp(clamped p) - y), each times mult_scale and valid
//   (svbfm_tpu/learners/sgd.py:87-100), mult_scale 2 (SGDA, which also writes
//   each entry's gradients gw_e [B, P], gv_e [B, P, K] and the atomicMax of
//   the flat entry index per attribute into winner [D], so the last entry
//   of the batch wins, as XLA's scatter keeps it), and pair (BPR: the
//   negative row is the positive one with the item-field id replaced by the
//   row's sampled negative, one more gather, scored from the same
//   registers; mult = -sigmoid(-(p_pos - p_neg)); the negative row adds
//   -mult times its gradients, and its count only where its id differs;
//   adding the two rows' gradients of a shared entry before one atomic was
//   no faster and is not done).  Adding a zero is skipped: it cannot change
//   a sum that starts at +0.  The entry's lane also writes the owner of its
//   attribute for X9b: owner[id] = the flat index of one of the batch's
//   entries naming id (b P + p; B P + b for the row's sampled item in pair
//   mode), whichever store lands last.
// X9b sgd_apply: over the batch's own entries, not over all D attributes:
//   the B P entries of the batch and, in pair mode, the B sampled items, G
//   lanes an entry (G the next power of two >= 1+K, at most 32, so an
//   entry's lanes sit in one warp).  The entry that X9a recorded as the
//   owner of its attribute (owner[id] == its index: exactly one entry of
//   the batch) takes the row's step, lanes over its 1+K channels:
//   theta <- theta * max(1 - lr reg, 0)^cnt - damp(cnt) g / max(cnt, 1),
//   damp(c) = (1 - (1 - rate)^c) / mult_scale; reg a scalar (its base
//   precomputed on the host) or 2 reg[attr_group[d]] (SGDA).  The owner
//   zeroes the row's accumulator; in SGDA mode it first copies its winning
//   entry's gradients into the last-seen caches grad_tab [D, 1+K] and
//   resets winner to -1.  Thread 0 of block 0 updates w0 from (n_eff, sum
//   mult) and zeroes acc0.  The owner table is read, never reset: the next
//   batch's X9a writes its own entries' owners, so a graph of launches, or
//   X9b run again on one accumulator, finds the same owners.  Where a
//   batch names at least D entries (BPR's 11,063 pairs: 33,189 entries
//   over 9,992 attributes), the wrapper passes no ids and a second kernel
//   steps every attribute instead, a warp each: the same rows' steps
//   (step_row) in fewer threads.
//   Why the rows no entry names can be left alone: X9a writes acc only at
//   the ids of the batch's entries (the positive rows' ids and, in pair
//   mode, the negative rows', whose ids are the positive ones or the
//   row's sampled item) and never adds a zero, so every other accumulator
//   row holds +0, and the dense step there is t pow(base, 0) - 0 0 / 1 = t,
//   for NaN and +-inf too (pow(x, 0) = 1 for every x, damp(0) = 0); its
//   winner is -1.  Entries with x = 0, rows with valid = 0 and negatives
//   equal to the positive item are in the list, so whatever they add is
//   applied.
// T11 tp_sgd_scatter (svbfm_tpu/parallel/tp_sgd.py:91-131): X9a's kernel
//   in a window mode (its template parameter kWindow) for the
//   feature-sharded SGD, whose table holds one feature shard, the ids
//   [lo, lo + D_loc) at local rows 0 .. D_loc - 1.  The row is not scored
//   from the table: T1's partials (lin | s_f | s2_f) of every shard,
//   summed by the feature all-reduce, give p = w0 + lin + 1/2 sum_f (s_f^2
//   - s2_f) (the square after the sum; lin left out with k1 off) and the
//   global s_f.  A warp a row, lanes over factors: mult as X9a forms it,
//   then each entry inside the window adds mult (s_f x - v_f x^2), v_f the
//   local table's, its count and mult x at id - lo; an entry outside adds
//   nothing and reads no table row.  No owner, no SGDA record, no pair
//   mode: after the data all-reduce of acc the shard's rows hold other
//   data shards' entries too, and X9b runs dense over the D_loc rows.
// X9c sgda_lambda: one launch of one thread-block cluster of blocks of 16
//   warps on neighbouring SMs, ceil(Bv/16) of them up to 16 (a
//   non-portable size the H100 holds; 8 where a card cannot hold one of
//   16), a warp a validation row, lanes over the 1+K channels (w, then the
//   factors).  Each entry's operands (group, theta, its last-seen
//   gradient) are loaded once, a warp's first rows' loads (up to 4 rows
//   at P <= 2, 2 at P <= 4) issued before the regs are staged in shared
//   memory and every later group's before its first row is summed; the
//   forecast theta' = theta - lr (grad + 2 reg theta) is formed once for
//   the clamped prediction, grad_loss gl = 2 (p - y) valid (classification
//   and Poisson: y (sigmoid(y p) - 1) valid, p not clamped, sgd.py:226-229)
//   and the lambda
//   gradients, which each lane adds an entry at a time into its warp's own
//   slots [G (1+K) + 1] in shared memory (no atomics; the sums over a
//   group are linear in its entries).  A block folds its warps' slots by a
//   shuffle tree; every block but 0 sends its slots to block 0 with
//   asynchronous distributed-shared-memory stores that count their bytes
//   on block 0's mbarrier, and leaves; block 0 adds the blocks' slots in
//   rank order and steps reg_w [G], reg_v [G, K].  No global atomic, fence
//   or counter, nothing to zero between launches, the same bits from two
//   launches.  Where the slots and the staged regs do not fit a block's
//   shared memory: fewer blocks, fewer warps, then the regs read from
//   device memory (the limit stays G (1+K) + 1 floats a block).  32-warp
//   blocks, a full cluster barrier in place of the mbarrier, a store and
//   arrival a slot, and prefetches of the next row were all slower.
//
// Bound: latency and launches.  At the ML-1M shape (B = 1024 rows, P = 2,
// K = 20) X9a moves ~0.3 MB, X9b the ~2,000 rows the batch names (~0.35
// MB), X9c's 113 validation rows ~42 KB, whatever D is: 0.10, 0.15 and
// 0.012 us at HBM rate, against 3.3-5 us each on an H100 80GB HBM3 at
// 700 W (PERF.md), where an empty op replayed in a CUDA graph takes
// 1.3-1.8 us; the rest is the latency of the dependent reads in a row (an
// entry's id, then its table row; X9b: the id, its owner, the row), the
// atomics' round trip and, in X9c, the blocks' combine.  An epoch is
// ~2,000 launches (~2,640 for an SGDA iteration), so the host's launch
// rate sets its pace.  The TPU design avoided scatters (they serialise
// there); here float atomics into L2-resident tables take their place.
#include <algorithm>
#include <type_traits>

#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // X9a's rows, X9b's attributes a block
constexpr int kLambdaWarps = 16;   // X9c: the most warps a cluster block
constexpr int kLambdaBlocks = 16;  // X9c: the most blocks a cluster
constexpr int kLossExp = 1;  // 0: regression
constexpr int kLossPair = 2;
constexpr int kLossClass = 3;
constexpr int kLossPoisson = 4;

// jnp.clip: a NaN stays NaN
__device__ __forceinline__ float clip_nan(float p, float lo, float hi) {
  return p < lo ? lo : (p > hi ? hi : p);
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// jnp.maximum(x, 0): a NaN stays NaN
__device__ __forceinline__ float max0_nan(float x) { return x < 0.f ? 0.f : x; }

// a store that may race with stores of other values to the same word (one
// of them lands), without waiting on anything
__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v));
}

struct Scatter {
  const float* tab;
  int K;
  const float* w0;
  const int* ids;
  const float* vals;
  const float* y;
  const float* valid;
  int64_t B;
  int P;
  int loss;
  int k0;
  int k1;
  float mult_scale;
  float min_t;
  float max_t;
  float stdev;
  const int* neg;  // pair mode: the row's sampled item
  int lo;
  int hi;  // pair mode: the item field [lo, hi)
  float* acc;
  float* acc0;
  float* gw_e;  // SGDA only (else null)
  float* gv_e;
  int* winner;
  int* owner;  // [D]: an entry of the batch naming each attribute
};

// T11's arguments: X9a's, the summed partials [B, 1 + 2K] and the window
// [win_lo, win_lo + D_loc) of the shard's table.
struct WindowScatter : Scatter {
  const float* part;
  int64_t win_lo;
  int D_loc;
};

// The loss multiplier of a row scored p (every mode but pair), times
// mult_scale and valid (svbfm_tpu/learners/sgd.py:87-100): X9a's, written
// out again in its kernel so that its builds keep their instructions.
__device__ __forceinline__ float loss_mult(const Scatter& a, float p,
                                           float yb, float valid) {
  if (a.loss == kLossExp) return a.mult_scale * (p / a.stdev - yb) * valid;
  if (a.loss == kLossClass)
    return a.mult_scale * yb * (1.f / (1.f + expf(-(yb * p))) - 1.f) * valid;
  if (a.loss == kLossPoisson)
    return a.mult_scale * (expf(clip_nan(p, a.min_t, a.max_t)) - yb) * valid;
  return a.mult_scale * (clip_nan(p, a.min_t, a.max_t) - yb) * valid;
}

// T11: row b of X9a's window mode (see the top), by the warp's lanes;
// returns the row's valid and multiplier for the block's acc0 sums.
__device__ __forceinline__ void window_row(const WindowScatter& a, int64_t b,
                                           int lane, float& n_eff,
                                           float& msum) {
  const int64_t ld = a.K + 1, la = a.K + 2, CH = 1 + 2 * int64_t{a.K};
  const int* rid = a.ids + b * a.P;
  const float* rx = a.vals + b * a.P;
  const float* prow = a.part + b * CH;
  const float valid = a.valid[b];
  float q = 0.f;
  for (int f = lane; f < a.K; f += 32) {
    const float s = prow[1 + f];
    q += s * s - prow[1 + a.K + f];
  }
  float p = (a.k1 ? prow[0] : 0.f) + 0.5f * svbfm::warp_sum(q);
  if (a.k0) p += *a.w0;
  const float mult = loss_mult(a, p, a.y[b], valid);
  for (int f = lane; f < a.K; f += 32) {
    const float s = prow[1 + f];
    for (int e = 0; e < a.P; ++e) {
      const int64_t loc = static_cast<int64_t>(__ldg(rid + e)) - a.win_lo;
      if (loc < 0 || loc >= a.D_loc) continue;  // another shard's id
      const float x = __ldg(rx + e);
      const float v = __ldg(a.tab + loc * ld + 1 + f);
      const float g = mult * (s * x - v * (x * x));
      if (g != 0.f) atomicAdd(a.acc + loc * la + 2 + f, g);
    }
  }
  for (int e = lane; e < a.P; e += 32) {
    const int64_t loc = static_cast<int64_t>(__ldg(rid + e)) - a.win_lo;
    if (loc < 0 || loc >= a.D_loc) continue;
    const float x = __ldg(rx + e);
    float* row = a.acc + loc * la;
    if (x != 0.f && valid != 0.f) atomicAdd(row, valid);
    const float gw = mult * x;
    if (a.k1 && gw != 0.f) atomicAdd(row + 1, gw);
  }
  n_eff = valid;
  msum = mult;
}

// A chunk of kP entries of a row as one lane holds them: ids, values, and
// the table's w and factor f at each (tab is read through the read-only
// path: X9a never writes it).
template <int kP>
struct RowChunk {
  int id[kP];
  float x[kP];
  float w[kP];
  float v[kP];
};

// Load entries p0 .. p0 + kP - 1 of row (rid, rx): every load of the chunk
// is issued before the first is used.
template <int kP>
__device__ __forceinline__ void load_chunk(const Scatter& a, const int* rid,
                                           const float* rx, int p0, int f,
                                           RowChunk<kP>& e) {
  const int64_t ld = a.K + 1;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const bool in = p0 + q < a.P;
    e.id[q] = in ? __ldg(rid + p0 + q) : 0;
    e.x[q] = in ? __ldg(rx + p0 + q) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const bool in = p0 + q < a.P;
    const float* row = a.tab + e.id[q] * ld;
    e.w[q] = in && a.k1 ? __ldg(row) : 0.f;
    e.v[q] = in && f < a.K ? __ldg(row + 1 + f) : 0.f;
  }
}

// The factor sums of a row at factor f: s = sum_p v x, s2 = sum_p (v x)^2
// (p in order), for the positive row and, in pair mode, the negative one
// (vn the sampled item's factor f).  The first chunk pass (f0 == 0) also
// adds the linear terms w x into lin and linn.
struct RowSums {
  float s, s2, sn, s2n;
};

template <int kP>
__device__ __forceinline__ void add_chunk(const Scatter& a,
                                          const RowChunk<kP>& e, int p0,
                                          bool pair, float vn, float wn,
                                          bool linear, RowSums& r, float& lin,
                                          float& linn) {
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    if (p0 + q >= a.P) break;
    const float d = e.v[q] * e.x[q];
    r.s += d;
    r.s2 += d * d;
    if (linear) lin += e.w[q] * e.x[q];
    if (pair) {
      const bool item = e.id[q] >= a.lo && e.id[q] < a.hi;
      const float dn = (item ? vn : e.v[q]) * e.x[q];
      r.sn += dn;
      r.s2n += dn * dn;
      if (linear) linn += (item ? wn : e.w[q]) * e.x[q];
    }
  }
}

// X9a: a warp a row (a pair in pair mode), lanes over factors.  The row's
// entries are gathered once: with P <= kP and K <= 32 the registers hold
// them from the score to the scatter; otherwise the scatter gathers them
// again (the same values: each entry's gradient keeps its bits).  kWindow:
// T11, a row by window_row (kP unread), from WindowScatter's arguments.
template <int kP, bool kWindow = false>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sgd_grad_scatter_kernel(
        std::conditional_t<kWindow, WindowScatter, Scatter> a) {
  __shared__ float red[2][kWarpsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  float n_eff = 0.f, msum = 0.f;
  if constexpr (kWindow) {
    if (b < a.B) window_row(a, b, lane, n_eff, msum);
  } else if (b < a.B) {  // the whole warp takes the branch together
    const int64_t ld = a.K + 1, la = a.K + 2;
    const int* rid = a.ids + b * a.P;
    const float* rx = a.vals + b * a.P;
    const bool pair = a.loss == kLossPair;
    const float valid = a.valid[b];
    const float yb = pair ? 0.f : a.y[b];
    const int negb = pair ? a.neg[b] : 0;
    const float* nrow = a.tab + static_cast<int64_t>(negb) * ld;
    const float wn = pair && a.k1 ? __ldg(nrow) : 0.f;
    const bool held = a.P <= kP && a.K <= 32;
    RowChunk<kP> e;
    RowSums kept{};
    float lin = a.k0 ? *a.w0 : 0.f, linn = lin, part = 0.f, partn = 0.f;
    for (int f0 = 0; f0 == 0 || f0 < a.K; f0 += 32) {
      const int f = f0 + lane;
      const float vn = pair && f < a.K ? __ldg(nrow + 1 + f) : 0.f;
      RowSums r{};
      for (int p0 = 0; p0 < a.P; p0 += kP) {
        load_chunk(a, rid, rx, p0, f, e);
        add_chunk(a, e, p0, pair, vn, wn, f0 == 0 && a.k1, r, lin, linn);
      }
      if (f < a.K) {
        part += 0.5f * (r.s * r.s - r.s2);
        partn += 0.5f * (r.sn * r.sn - r.s2n);
      }
      if (f0 == 0) kept = r;
    }
    const float p = lin + svbfm::warp_sum(part);
    float mult;
    if (pair) {
      const float d = p - (linn + svbfm::warp_sum(partn));
      mult = -(1.f / (1.f + expf(d))) * valid;  // -sigmoid(-d)
    } else if (a.loss == kLossExp) {
      mult = a.mult_scale * (p / a.stdev - yb) * valid;
    } else if (a.loss == kLossClass) {
      mult = a.mult_scale * yb * (1.f / (1.f + expf(-(yb * p))) - 1.f) * valid;
    } else if (a.loss == kLossPoisson) {
      mult = a.mult_scale * (expf(clip_nan(p, a.min_t, a.max_t)) - yb) * valid;
    } else {
      mult = a.mult_scale * (clip_nan(p, a.min_t, a.max_t) - yb) * valid;
    }
    // the v-gradients, lanes over factors: mult (s x - v x^2), and in pair
    // mode the negative row's -mult (sn x - v' x^2) at its entry's id
    for (int f0 = 0; f0 < a.K; f0 += 32) {
      const int f = f0 + lane;
      const float vn = pair && f < a.K ? __ldg(nrow + 1 + f) : 0.f;
      RowSums r = kept;
      if (!held) {
        float unused = 0.f;
        r = RowSums{};
        for (int p0 = 0; p0 < a.P; p0 += kP) {
          load_chunk(a, rid, rx, p0, f, e);
          add_chunk(a, e, p0, pair, vn, wn, false, r, unused, unused);
        }
      }
      if (f >= a.K) continue;
      for (int p0 = 0; p0 < a.P; p0 += kP) {
        if (!held) load_chunk(a, rid, rx, p0, f, e);
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          if (p0 + q >= a.P) break;
          const int id = e.id[q];
          const float x = e.x[q];
          const float g = mult * (r.s * x - e.v[q] * (x * x));
          if (a.gv_e != nullptr) a.gv_e[(b * a.P + p0 + q) * a.K + f] = g;
          if (g != 0.f) atomicAdd(a.acc + id * la + 2 + f, g);
          if (pair) {
            const bool item = id >= a.lo && id < a.hi;
            const float gn =
                -mult * (r.sn * x - (item ? vn : e.v[q]) * (x * x));
            const int idn = item ? negb : id;
            if (gn != 0.f) atomicAdd(a.acc + idn * la + 2 + f, gn);
          }
        }
      }
    }
    // the per-entry updates, a lane an entry: X9b's owner, the count (the
    // positive row counts its nonzero entries, the negative row only the
    // sampled item where it differs from the positive one), the
    // w-gradient mult x, and SGDA's entry record and winner
    for (int p = lane; p < a.P; p += 32) {
      const int id = __ldg(rid + p);
      const float x = __ldg(rx + p);
      const int flat = static_cast<int>(b * a.P + p);
      store_relaxed(&a.owner[id], flat);
      float* row = a.acc + id * la;
      if (x != 0.f && valid != 0.f) atomicAdd(row, valid);
      const float gw = mult * x;
      if (a.k1 && gw != 0.f) atomicAdd(row + 1, gw);
      if (pair) {
        const int idn = id >= a.lo && id < a.hi ? negb : id;
        if (idn != id && valid != 0.f) atomicAdd(a.acc + idn * la, valid);
        const float gwn = -mult * x;
        if (a.k1 && gwn != 0.f) atomicAdd(a.acc + idn * la + 1, gwn);
      }
      if (a.gw_e != nullptr) {
        a.gw_e[flat] = gw;
        if (x != 0.f && valid > 0.f) atomicMax(&a.winner[id], flat);
      }
    }
    if (pair && lane == 0)
      store_relaxed(&a.owner[negb], static_cast<int>(a.B * a.P + b));
    n_eff = valid;
    msum = mult;
  }
  if (lane == 0) {
    red[0][warp] = n_eff;
    red[1][warp] = msum;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kWarpsPerBlock;
    const float n = svbfm::warp_sum(in ? red[0][lane] : 0.f);
    const float m = svbfm::warp_sum(in ? red[1][lane] : 0.f);
    if (lane == 0) {
      atomicAdd(&a.acc0[0], n);
      atomicAdd(&a.acc0[1], m);
    }
  }
}

struct Apply {
  float* tab;
  int K;
  float* acc;
  float lr;
  float decay;  // 1 - min(lr mult_scale, 1)
  float mult_scale;
  float base_w;  // scalar-reg modes: max(1 - lr reg, 0) from the host
  float base_v;
  const float* reg_w;  // SGDA: per-group regs (else null)
  const float* reg_v;
  const int* attr_group;
  int k0;
  int k1;
  float* w0;
  float* acc0;
  float w0_base;
  int w0_grad;
  int* winner;  // SGDA: the last-seen caches (else null)
  const float* gw_e;
  const float* gv_e;
  float* grad_tab;
  const int* ids;  // the batch's entries [n_pos]; null: every attribute
  int64_t n_pos;
  const int* neg;  // pair mode: the rows' sampled items [n_neg] (else null)
  int64_t n_neg;
  const int* owner;  // [D], from X9a
  int lanes;         // G, lanes an entry
};

__device__ __forceinline__ float damp(const Apply& a, float c) {
  return (1.f - powf(a.decay, c)) / a.mult_scale;
}

// w0's step from (n_eff, sum mult), and acc0 zeroed: thread 0 of block 0
__device__ __forceinline__ void w0_step(const Apply& a) {
  const float n = a.acc0[0], g0 = a.acc0[1];
  if (a.k0) {
    float w0 = *a.w0 * powf(a.w0_base, n);
    if (a.w0_grad) w0 = w0 - damp(a, n) * g0 / fmaxf(n, 1.f);
    *a.w0 = w0;
  }
  a.acc0[0] = 0.f;
  a.acc0[1] = 0.f;
}

// Attribute d's step, by the G lanes of `group` (lane the caller's among
// them) over the row's 1+K channels; its accumulator row zeroed, and in
// SGDA mode its winner's gradients copied into the caches.
__device__ __forceinline__ void step_row(const Apply& a, int64_t d, int lane,
                                         int G, unsigned group) {
  const int ld = a.K + 1;
  float* acc_d = a.acc + d * (a.K + 2);
  float* t = a.tab + d * ld;
  const float cnt = acc_d[0];
  const float cnt1 = fmaxf(cnt, 1.f);
  const float dc = damp(a, cnt);
  const int g = a.attr_group != nullptr ? a.attr_group[d] : 0;
  for (int c = lane; c < ld; c += G) {
    if (c == 0 && !a.k1) continue;
    float base;
    if (a.attr_group != nullptr) {
      const float reg = c == 0 ? a.reg_w[g] : a.reg_v[g * a.K + c - 1];
      base = max0_nan(1.f - a.lr * (2.f * reg));
    } else {
      base = c == 0 ? a.base_w : a.base_v;
    }
    t[c] = t[c] * powf(base, cnt) - dc * acc_d[1 + c] / cnt1;
    acc_d[1 + c] = 0.f;
  }
  if (a.winner != nullptr) {
    const int wi = a.winner[d];
    if (wi >= 0) {
      for (int c = lane; c < ld; c += G)
        a.grad_tab[d * ld + c] =
            c == 0 ? a.gw_e[wi]
                   : a.gv_e[static_cast<int64_t>(wi) * a.K + c - 1];
    }
  }
  __syncwarp(group);  // every lane has read cnt and winner
  if (lane == 0) {
    acc_d[0] = 0.f;
    if (a.winner != nullptr) a.winner[d] = -1;
  }
}

// X9b over the batch's entries: G lanes an entry, the owner steps its row.
__global__ void sgd_apply_kernel(Apply a) {
  const int G = a.lanes;
  const int wl = threadIdx.x & 31;
  const int lead = wl & ~(G - 1);  // the entry's first lane in the warp
  if (blockIdx.x == 0 && threadIdx.x == 0) w0_step(a);
  // G is a power of two: a shift, not a 64-bit division
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
      (__ffs(G) - 1);
  if (i >= a.n_pos + a.n_neg) return;  // an entry's lanes leave together
  const int id = i < a.n_pos ? a.ids[i] : a.neg[i - a.n_pos];
  if (a.owner[id] != i) return;
  step_row(a, id, wl - lead, G,
           G == 32 ? svbfm::kFullMask : ((1u << G) - 1u) << lead);
}

// X9b over every attribute (a batch of D entries or more): a warp each.
__global__ void sgd_apply_dense_kernel(Apply a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) w0_step(a);
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= a.n_pos) return;  // the whole warp leaves together
  step_row(a, d, threadIdx.x & 31, 32, svbfm::kFullMask);
}

struct Lambda {
  const float* tab;
  const float* grad_tab;
  int K;
  const float* w0;
  float* reg_w;
  float* reg_v;
  const int* attr_group;
  int G;
  const int* ids;
  const float* vals;
  const float* y;
  const float* valid;
  int64_t B;
  int P;
  float lr;
  float m2lr;    // -2 lr
  float decay1;  // 1 - min(lr, 1)
  float min_t;
  float max_t;
  int class_loss;  // the classification (and Poisson) grad_loss
  int k0;
  int k1;
  int staged;  // the regs are staged in shared memory
};

// A chunk of kP entries of a validation row as the lane of channel c
// (0: w, 1 + f: factor f) holds them: ids, values, groups, theta at c and
// its last-seen gradient, then the forecast theta' = theta - lr (grad +
// 2 reg theta) in its place.
template <int kP>
struct ValChunk {
  int id[kP];
  float x[kP];
  int g[kP];
  float t[kP];
  float d[kP];
};

// Load entries p0 .. p0 + kP - 1 of row b at channel c, each level's loads
// issued together: ids and values, then groups, theta and gradient.
template <int kP>
__device__ __forceinline__ void load_val_chunk(const Lambda& a, int64_t b,
                                               int p0, int c,
                                               ValChunk<kP>& e) {
  const int nc = a.K + 1;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const bool in = p0 + q < a.P;
    e.id[q] = in ? __ldg(a.ids + b * a.P + p0 + q) : 0;
    e.x[q] = in ? __ldg(a.vals + b * a.P + p0 + q) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const bool in = p0 + q < a.P && c < nc;
    const int64_t at = static_cast<int64_t>(e.id[q]) * nc + c;
    e.g[q] = in ? __ldg(a.attr_group + e.id[q]) : 0;
    e.t[q] = in ? __ldg(a.tab + at) : 0.f;
    e.d[q] = in ? __ldg(a.grad_tab + at) : 0.f;
  }
}

// theta' from the chunk's theta and gradient and the reg of its group
// (shared memory when staged: [G][1+K], w's first)
template <int kP>
__device__ __forceinline__ void forecast(const Lambda& a, const float* sreg,
                                         int p0, int c, ValChunk<kP>& e) {
  const int nc = a.K + 1;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    if (p0 + q >= a.P || c >= nc) break;
    const float r = sreg != nullptr ? sreg[e.g[q] * nc + c]
                    : c == 0        ? a.reg_w[e.g[q]]
                                    : a.reg_v[e.g[q] * a.K + c - 1];
    e.d[q] = e.t[q] - a.lr * (e.d[q] + 2.f * r * e.t[q]);
  }
}

// s += x theta' mask and s2 += (x theta' mask)^2 over the chunk, p in
// order (mask = valid where x != 0, else 0)
template <int kP>
__device__ __forceinline__ void add_sums(const Lambda& a,
                                         const ValChunk<kP>& e, int p0,
                                         float valid, float& s, float& s2) {
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    if (p0 + q >= a.P) break;
    const float d = e.d[q] * e.x[q] * (e.x[q] != 0.f ? valid : 0.f);
    s += d;
    s2 += d * d;
  }
}

// grad_loss gl = 2 (clip(p) - y) valid of a row, or y (sigmoid(y p) - 1)
// valid under the classification loss (every lane gets it):
// p = w0 (read at launch) + sw, the w channel's sum (lane 0's), + the sum
// over the factors of (s_f^2 - s2_f) / 2, this lane's share in ``quad``
__device__ __forceinline__ float row_gl(const Lambda& a, float w0, float quad,
                                        float sw, float y, float valid) {
  quad = svbfm::warp_sum(quad);
  sw = __shfl_sync(svbfm::kFullMask, sw, 0);
  float pr = a.k0 ? w0 : 0.f;
  if (a.k1) pr += sw;
  pr += quad;
  if (a.class_loss) return y * (1.f / (1.f + expf(-(y * pr))) - 1.f) * valid;
  return 2.f * (clip_nan(pr, a.min_t, a.max_t) - y) * valid;
}

// The chunk's lambda-gradient terms at channel c < 1+K, added by the
// channel's lane into the warp's slots ``part`` [G (1+K) + 1]: w's
// gl (-2 lr) x w mask, factor f's gl (-2 lr) (s_f x v mask - x theta' mask
// v x mask), s_f the row's channel sum.  The sums over a row's group are
// linear in its entries, so no pass finds the groups.
template <int kP>
__device__ __forceinline__ void add_terms(const Lambda& a, float* part,
                                          const ValChunk<kP>& e, int p0,
                                          int c, float s, float gl,
                                          float valid) {
  const int nc = a.K + 1;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    if (p0 + q >= a.P) break;
    const float x = e.x[q];
    const float m = x != 0.f ? valid : 0.f;
    if (!(m > 0.f)) continue;  // a masked entry: in no group's sums
    float* slot = part + e.g[q] * nc + c;
    const float xt = x * e.t[q] * m;
    if (c == 0) {
      *slot += gl * a.m2lr * xt;
    } else {
      const float tt = x * e.d[q] * m * e.t[q] * x * m;
      *slot += gl * (a.m2lr * (s * xt - tt));
    }
  }
}

// JAX sums every group of every row: a group the row does not touch adds
// gl (-2 lr) 0, which is NaN when gl is not finite, and the v terms' s_f 0
// is NaN when s_f is not finite
__device__ __forceinline__ void poison(const Lambda& a, float* part, int c,
                                       float s, float gl) {
  if (isfinite(gl) && (c == 0 || isfinite(s))) return;
  for (int g = 0; g < a.G; ++g) part[g * (a.K + 1) + c] += quiet_nan();
}

// kR rows of a warp (b, b + stride, ...; those past B are skipped) whose
// entries a lane holds whole: P <= kP and 1+K <= 32.  Every row's loads
// are issued before the first row is summed.
template <int kP, int kR>
struct RowGroup {
  ValChunk<kP> e[kR];
  float valid[kR];
  float y[kR];
};

template <int kP, int kR>
__device__ __forceinline__ void load_group(const Lambda& a, int64_t b,
                                           int64_t stride, int lane,
                                           RowGroup<kP, kR>& rg) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int64_t br = b + r * stride;
    if (br >= a.B) break;
    rg.valid[r] = a.valid[br];
    rg.y[r] = a.y[br];
    load_val_chunk(a, br, 0, lane, rg.e[r]);
  }
}

template <int kP, int kR>
__device__ __forceinline__ void held_group(const Lambda& a, const float* sreg,
                                           float w0, float* part, int64_t b,
                                           int64_t stride, int lane,
                                           RowGroup<kP, kR>& rg) {
  const int nc = a.K + 1;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (b + r * stride >= a.B) break;
    ValChunk<kP>& e = rg.e[r];
    const float valid = rg.valid[r];
    forecast(a, sreg, 0, lane, e);
    float s = 0.f, s2 = 0.f;
    add_sums(a, e, 0, valid, s, s2);
    const float gl = row_gl(
        a, w0, lane >= 1 && lane < nc ? 0.5f * (s * s - s2) : 0.f, s,
        rg.y[r], valid);
    if (lane < nc) {
      poison(a, part, lane, s, gl);
      add_terms(a, part, e, 0, lane, s, gl, valid);
    }
    if (lane == 0) part[a.G * nc] += valid;
  }
}

// One validation row of any P and K by one warp, lanes over the channels
// (32 at a time), the entries kP at a time, gathered again for the terms.
template <int kP>
__device__ __forceinline__ void any_row(const Lambda& a, const float* sreg,
                                        float w0, float* part, int64_t b,
                                        int lane) {
  const int nc = a.K + 1;
  const float valid = a.valid[b];
  ValChunk<kP> e;
  auto sums = [&](int c, float& s, float& s2) {
    s = 0.f;
    s2 = 0.f;
    for (int p0 = 0; p0 < a.P; p0 += kP) {
      load_val_chunk(a, b, p0, c, e);
      forecast(a, sreg, p0, c, e);
      add_sums(a, e, p0, valid, s, s2);
    }
  };
  float quad = 0.f, sw = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    float s, s2;
    sums(c, s, s2);
    if (c == 0) sw = s;
    if (c >= 1 && c < nc) quad += 0.5f * (s * s - s2);
  }
  const float gl = row_gl(a, w0, quad, sw, a.y[b], valid);
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    float s, s2;
    sums(c, s, s2);
    if (c >= nc) continue;
    poison(a, part, c, s, gl);
    for (int p0 = 0; p0 < a.P; p0 += kP) {
      load_val_chunk(a, b, p0, c, e);
      forecast(a, sreg, p0, c, e);
      add_terms(a, part, e, p0, c, s, gl, valid);
    }
  }
  if (lane == 0) part[a.G * nc] += valid;
}

// The cluster's synchronisation, in PTX: a shared-memory address of this
// block, the same address in block ``rank``'s shared memory, and the
// split cluster barrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t in_block(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// X9c: one launch of one cluster (gridDim.x blocks, the grid's only
// cluster), a warp a validation row, kR rows a warp in flight where it has
// several.  Each warp adds into slots of its own; a warp a slot folds the
// block's warps' slots by a shuffle tree.  Every block but 0 then sends
// its folded slots to block 0's shared memory with asynchronous stores
// that count their bytes on block 0's mbarrier (initialised before the
// cluster barrier's arrive at launch, waited on before the first store),
// and leaves; block 0 waits for the barrier's phase, adds the blocks'
// slots in rank order and steps the regs.  No global atomic, no block
// waits on another but block 0, and two launches give the same bits.
// With several blocks, slots are padded to whole 16-byte vectors (nsum4
// floats a warp or block) and the mbarrier follows the received slots.
template <int kP, int kR>
__global__ void __launch_bounds__(32 * kLambdaWarps)
    sgda_lambda_kernel(Lambda a) {
  // [staged regs G (1+K)] [warps][nsum4] [blocks 1..][nsum4] [mbarrier]
  extern __shared__ __align__(16) float sh[];
  const int nc = a.K + 1, nreg = a.G * nc, nsum = nreg + 1;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned rank = blockIdx.x, nb = gridDim.x;
  const int pad = nb > 1 ? 3 : 0;
  const int nsum4 = (nsum + pad) & ~pad;
  float* part = sh + (a.staged ? (nreg + pad) & ~pad : 0);
  float* recv = part + nw * nsum4;  // block 0's: the other blocks' sums
  float* mine = part + warp * nsum4;
  // block 0's: the other blocks' bytes
  uint64_t* arrived = reinterpret_cast<uint64_t*>(recv + (nb - 1) * nsum4);
  const int64_t stride = static_cast<int64_t>(nb) * nw;
  const int64_t first = static_cast<int64_t>(rank) * nw + warp;
  const bool held = a.P <= kP && nc <= 32;
  RowGroup<kP, kR> rg;
  if (held) load_group(a, first, stride, lane, rg);  // while regs stage
  const float w0 = *a.w0;
  if (rank == 0 && threadIdx.x == 0 && nb > 1) {
    const uint32_t bar = smem_addr(arrived);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(static_cast<unsigned>((nb - 1) * nsum4 * 4)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  if (a.staged) {
    for (int i = threadIdx.x; i < nreg; i += blockDim.x) {
      const int g = i / nc, c = i % nc;
      sh[i] = c == 0 ? a.reg_w[g] : a.reg_v[g * a.K + c - 1];
    }
  }
  for (int i = threadIdx.x; i < nw * nsum4; i += blockDim.x) part[i] = 0.f;
  __syncthreads();
  const float* sreg = a.staged ? sh : nullptr;
  if (held) {
    for (int64_t b = first; b < a.B; b += kR * stride) {
      if (b != first) load_group(a, b, stride, lane, rg);
      held_group(a, sreg, w0, mine, b, stride, lane, rg);
    }
  } else {
    for (int64_t b = first; b < a.B; b += stride)
      any_row<kP>(a, sreg, w0, mine, b, lane);
  }
  __syncthreads();
  // slot i over the block's warps, in a fixed tree, into warp 0's slots
  for (int i = warp; i < nsum; i += nw) {
    const float v = svbfm::warp_sum(lane < nw ? part[lane * nsum4 + i] : 0.f);
    if (lane == 0) part[i] = v;
  }
  __syncthreads();
  if (rank != 0) {
    // block 0's mbarrier is initialised (every block arrived at launch)
    asm volatile("barrier.cluster.wait;" ::: "memory");
    if (warp != 0) return;
    const uint32_t bar0 = in_block(smem_addr(arrived), 0);
    const uint32_t to = in_block(smem_addr(recv + (rank - 1) * nsum4), 0);
    for (int j = lane; j < nsum4 / 4; j += 32) {
      const float4 v = reinterpret_cast<const float4*>(part)[j];
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(to + 16 * j),
          "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar0)
          : "memory");
    }
    return;
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");
  // every other block's bytes are in: the phase of block 0's mbarrier
  for (uint32_t done = nb == 1, spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(arrived))
        : "memory");
    if (spins == (1u << 24)) __trap();  // never: fail loudly, not hang
  }
  float n_v = part[nreg];
  for (unsigned r = 1; r < nb; ++r) n_v += recv[(r - 1) * nsum4 + nreg];
  const float scale_l =
      (1.f - powf(a.decay1, n_v)) / (a.lr * fmaxf(n_v, 1.f));
  const float ls = a.lr * scale_l;
  for (int i = threadIdx.x; i < nreg; i += blockDim.x) {
    float d = part[i];
    for (unsigned r = 1; r < nb; ++r) d += recv[(r - 1) * nsum4 + i];
    const int g = i / nc, c = i % nc;
    float* r = c == 0 ? &a.reg_w[g] : &a.reg_v[g * a.K + c - 1];
    *r = max0_nan((a.staged ? sh[i] : *r) - ls * d);
  }
}

inline unsigned warp_blocks(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// X9a.  neg/lo/hi are read in pair mode only; gw_e, gv_e and winner are
// null unless SGDA's caches are kept; owner [D] is X9b's.
SVBFM_EXPORT int svbfm_sgd_grad_scatter(
    const float* tab, int K, const float* w0, const int* ids, const float* vals,
    const float* y, const float* valid, int64_t B, int P, int loss, int k0,
    int k1, float mult_scale, float min_t, float max_t, float stdev,
    const int* neg, int lo, int hi, float* acc, float* acc0, float* gw_e,
    float* gv_e, int* winner, int* owner, cudaStream_t stream) {
  Scatter a{tab, K, w0, ids, vals, y, valid, B, P, loss, k0, k1, mult_scale,
            min_t, max_t, stdev, neg, lo, hi, acc, acc0, gw_e, gv_e, winner,
            owner};
  const unsigned blocks = warp_blocks(B);
  if (blocks == 0) return 0;
  auto kernel =
      P <= 2 ? sgd_grad_scatter_kernel<2> : sgd_grad_scatter_kernel<4>;
  kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// T11: X9a's window mode on rows ids/vals [B, P] (global ids) of a shard's
// table tab [D_loc, 1+K] (ids [lo, lo + D_loc)), from their partials part
// [B, 1 + 2K] summed over the feature shards; adds into acc [D_loc, 2+K]
// and acc0 [2].  Every loss but pair.
SVBFM_EXPORT int svbfm_tp_sgd_scatter(
    const float* tab, int K, const float* w0, const int* ids, const float* vals,
    const float* y, const float* valid, int64_t B, int P, const float* part,
    int64_t win_lo, int D_loc, int loss, int k0, int k1, float mult_scale,
    float min_t, float max_t, float stdev, float* acc, float* acc0,
    cudaStream_t stream) {
  if (loss == kLossPair) return static_cast<int>(cudaErrorInvalidValue);
  WindowScatter a{{tab, K, w0, ids, vals, y, valid, B, P, loss, k0, k1,
                   mult_scale, min_t, max_t, stdev, nullptr, 0, 0, acc,
                   acc0, nullptr, nullptr, nullptr, nullptr},
                  part, win_lo, D_loc};
  const unsigned blocks = warp_blocks(B);
  if (blocks == 0) return 0;
  sgd_grad_scatter_kernel<2, true>
      <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// X9b over the batch's n_pos entries ids and, in pair mode, its n_neg
// sampled items neg (else null), after X9a on the same batch wrote owner;
// with ids null, over every attribute, n_pos = D (n_neg = 0).
// reg_w/reg_v/attr_group are null in the scalar-reg modes; winner, gw_e,
// gv_e and grad_tab are null unless SGDA's caches are kept.
SVBFM_EXPORT int svbfm_sgd_apply(
    float* tab, int K, float* acc, float lr, float decay, float mult_scale,
    float base_w, float base_v, const float* reg_w, const float* reg_v,
    const int* attr_group, int k0, int k1, float* w0, float* acc0,
    float w0_base, int w0_grad, int* winner, const float* gw_e,
    const float* gv_e, float* grad_tab, const int* ids, int64_t n_pos,
    const int* neg, int64_t n_neg, const int* owner, cudaStream_t stream) {
  int G = 1;
  while (G < K + 1 && G < 32) G <<= 1;
  Apply a{tab, K, acc, lr, decay, mult_scale, base_w, base_v, reg_w, reg_v,
          attr_group, k0, k1, w0, acc0, w0_base, w0_grad, winner, gw_e, gv_e,
          grad_tab, ids, n_pos, neg, n_neg, owner, G};
  // at least one block: w0's step happens on an empty batch
  const int per_block = 32 * kWarpsPerBlock;
  if (ids == nullptr) {
    sgd_apply_dense_kernel<<<n_pos > 0 ? warp_blocks(n_pos) : 1, per_block,
                             0, stream>>>(a);
  } else {
    const int64_t threads = (n_pos + n_neg) * G;
    const unsigned blocks =
        threads > 0
            ? static_cast<unsigned>((threads + per_block - 1) / per_block)
            : 1;
    sgd_apply_kernel<<<blocks, per_block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// X9c: one cluster of min(kLambdaBlocks, ceil(B / warps)) blocks (one
// block for an empty batch, so the reg step happens), cut to the 8 blocks
// of the portable size where the card holds no cluster of more, or to
// max_blocks where that is > 0 (a test pins that fallback with it), as
// many warps a block as the warps' slots and the staged regs let fit in
// shared memory, at most kLambdaWarps.
SVBFM_EXPORT int svbfm_sgda_lambda(
    const float* tab, const float* grad_tab, int K, const float* w0,
    float* reg_w, float* reg_v, const int* attr_group, int G, const int* ids,
    const float* vals, const float* y, const float* valid, int64_t B, int P,
    float lr, float m2lr, float decay1, float min_t, float max_t,
    int class_loss, int k0, int k1, int max_blocks, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nreg = static_cast<int64_t>(G) * (K + 1), nsum = nreg + 1;
  const int64_t room = max_smem / 4;
  const int staged = nreg + nsum <= room;
  const int64_t nw = std::min<int64_t>(
      kLambdaWarps, (room - (staged ? nreg : 0)) / nsum);
  if (nw < 1) return static_cast<int>(cudaErrorInvalidValue);
  // floats of shared memory for nb blocks: past one, the slots padded to
  // 16 bytes, the received blocks' and the mbarrier
  auto floats = [&](int64_t nb) {
    if (nb == 1) return (staged ? nreg : 0) + nw * nsum;
    const int64_t nsum4 = (nsum + 3) / 4 * 4;
    return (staged ? (nreg + 3) / 4 * 4 : 0) + (nw + nb - 1) * nsum4 + 4;
  };
  const int64_t cap = max_blocks > 0
                          ? std::min(max_blocks, kLambdaBlocks)
                          : kLambdaBlocks;
  int64_t blocks = B > 0 ? std::min<int64_t>(cap, (B + nw - 1) / nw) : 1;
  while (floats(blocks) > room) --blocks;
  Lambda a{tab,   grad_tab, K,      w0,    reg_w, reg_v,      attr_group,
           G,     ids,      vals,   y,     valid, B,          P,
           lr,    m2lr,     decay1, min_t, max_t, class_loss, k0,
           k1,    staged};
  auto kernel = P <= 2 ? sgda_lambda_kernel<2, 4> : sgda_lambda_kernel<4, 2>;
  const size_t smem = sizeof(float) * floats(blocks);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(static_cast<unsigned>(32 * nw));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (blocks > 8) {  // past the portable size: 8 where the card holds no 16
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int fits = 0;
    if (err == cudaSuccess) {
      cfg.gridDim = dim3(static_cast<unsigned>(blocks));
      cluster.val.clusterDim.x = static_cast<unsigned>(blocks);
      err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fits < 1) blocks = 8;
  }
  cfg.dynamicSmemBytes = sizeof(float) * floats(blocks);
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cluster.val.clusterDim.x = static_cast<unsigned>(blocks);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
