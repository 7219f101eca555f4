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
//   factors.  The warp scores the row from the parameters before the batch
//   (it never writes tab), forms the loss multiplier, and atomically adds
//   each entry's count, w-gradient mult*x and v-gradients
//   mult*(s_f x - v_f x^2) into acc; n_eff and sum mult are reduced per
//   block and added once a block.  Modes: regression (clamped p - y), the
//   exponential family (p/stdev - y), mult_scale 2 (SGDA, which also writes
//   each entry's gradients gw_e [B, P], gv_e [B, P, K] and the atomicMax of
//   the flat entry index per attribute into winner [D], so the last entry
//   of the batch wins, as XLA's scatter keeps it), and pair (BPR: the
//   negative row is the positive one with the item-field id replaced by the
//   row's sampled negative; mult = -sigmoid(-(p_pos - p_neg)); the negative
//   row adds -mult times its gradients, and its count only where its id
//   differs).  Adding a zero is skipped: it cannot change a sum that starts
//   at +0.  A row's warp also writes the owner of each attribute the row
//   names for X9b, a lane an entry: owner[id] = the flat index of one of
//   the batch's entries naming id (b P + p; B P + b for the row's sampled
//   item in pair mode), whichever store lands last.
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
// X9c sgda_lambda: one warp per validation row: the forecast
//   theta' = theta - lr (grad + 2 reg theta) at the row's entries, the
//   clamped prediction, grad_loss = 2 (p - y) valid, and the per-group
//   lambda gradients, summed per row within each group (JAX's order), then
//   per block in shared memory [G (1+K) + 1] and added once a block; the
//   last block to finish (a done-counter) steps reg_w [G], reg_v [G, K] and
//   zeroes the sums and the counter.
//
// Bound: memory and launches.  At the ML-1M shape (B = 1024 rows, P = 2,
// K = 20) X9a moves ~0.3 MB, X9b the ~2,000 rows the batch names (~0.35
// MB), whatever D is: a few microseconds at HBM rate and less from L2,
// set by the latency of three reads in a row (the entry's id, its owner,
// the row); an epoch is ~2,000 launches, so the host's launch rate sets
// its pace.  The TPU design avoided scatters (they serialise there); here
// float atomics into L2-resident tables take their place.
#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLossExp = 1;  // 0: regression
constexpr int kLossPair = 2;

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

// the entry's id in the positive row, or in the negative row of a pair
__device__ __forceinline__ int entry_id(const Scatter& a, const int* rid,
                                        int p, bool negrow, int negb) {
  const int id = rid[p];
  return (negrow && id >= a.lo && id < a.hi) ? negb : id;
}

// FM score of one row (every lane gets it)
__device__ float row_score(const Scatter& a, const int* rid, const float* rx,
                           bool negrow, int negb, int lane) {
  const int64_t ld = a.K + 1;
  float part = 0.f;
  for (int f = lane; f < a.K; f += 32) {
    float s = 0.f, s2 = 0.f;
    for (int p = 0; p < a.P; ++p) {
      const float d = a.tab[entry_id(a, rid, p, negrow, negb) * ld + 1 + f] *
                      rx[p];
      s += d;
      s2 += d * d;
    }
    part += 0.5f * (s * s - s2);
  }
  part = svbfm::warp_sum(part);
  float lin = a.k0 ? *a.w0 : 0.f;
  if (a.k1) {
    for (int p = 0; p < a.P; ++p)
      lin += a.tab[entry_id(a, rid, p, negrow, negb) * ld] * rx[p];
  }
  return lin + part;
}

// scatter one row's entries with multiplier ``mult`` into acc
__device__ void scatter_row(const Scatter& a, const int* rid, const float* rx,
                            bool negrow, int negb, float mult, float valid,
                            int64_t b, int lane) {
  const int64_t ld = a.K + 1, la = a.K + 2;
  for (int f = lane; f < a.K; f += 32) {
    float s = 0.f;
    for (int p = 0; p < a.P; ++p)
      s += a.tab[entry_id(a, rid, p, negrow, negb) * ld + 1 + f] * rx[p];
    for (int p = 0; p < a.P; ++p) {
      const int id = entry_id(a, rid, p, negrow, negb);
      const float x = rx[p];
      const float g = mult * (s * x - a.tab[id * ld + 1 + f] * (x * x));
      if (g != 0.f) atomicAdd(&a.acc[id * la + 2 + f], g);
      if (a.gv_e != nullptr) a.gv_e[(b * a.P + p) * a.K + f] = g;
    }
  }
  if (lane != 0) return;
  for (int p = 0; p < a.P; ++p) {
    const int id = entry_id(a, rid, p, negrow, negb);
    const float x = rx[p];
    // the positive row counts its nonzero entries, the negative row only
    // the sampled item where it differs from the positive one
    const bool touch = negrow ? id != rid[p] : x != 0.f;
    if (touch && valid != 0.f) atomicAdd(&a.acc[id * la], valid);
    const float gw = mult * x;
    if (a.k1 && gw != 0.f) atomicAdd(&a.acc[id * la + 1], gw);
    if (a.gw_e != nullptr) {
      a.gw_e[b * a.P + p] = gw;
      if (x != 0.f && valid > 0.f)
        atomicMax(&a.winner[id], static_cast<int>(b * a.P + p));
    }
  }
}

__global__ void sgd_grad_scatter_kernel(Scatter a) {
  __shared__ float red[2][kWarpsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  float n_eff = 0.f, msum = 0.f;
  if (b < a.B) {  // the whole warp takes the branch together
    const int* rid = a.ids + b * a.P;
    const float* rx = a.vals + b * a.P;
    const float valid = a.valid[b];
    const int negb = a.loss == kLossPair ? a.neg[b] : 0;
    // X9b's owners, a lane an entry (the sampled item's after the pair's
    // scatter, when neg[b] has long arrived)
    for (int p = lane; p < a.P; p += 32)
      store_relaxed(&a.owner[rid[p]], static_cast<int>(b * a.P + p));
    const float p = row_score(a, rid, rx, false, 0, lane);
    float mult;
    if (a.loss == kLossPair) {
      const float d = p - row_score(a, rid, rx, true, negb, lane);
      mult = -(1.f / (1.f + expf(d))) * valid;  // -sigmoid(-d)
    } else if (a.loss == kLossExp) {
      mult = a.mult_scale * (p / a.stdev - a.y[b]) * valid;
    } else {
      mult = a.mult_scale * (clip_nan(p, a.min_t, a.max_t) - a.y[b]) * valid;
    }
    scatter_row(a, rid, rx, false, negb, mult, valid, b, lane);
    if (a.loss == kLossPair) {
      scatter_row(a, rid, rx, true, negb, -mult, valid, b, lane);
      if (lane == 0)
        store_relaxed(&a.owner[negb], static_cast<int>(a.B * a.P + b));
    }
    n_eff = valid;
    msum = mult;
  }
  if (lane == 0) {
    red[0][warp] = n_eff;
    red[1][warp] = msum;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[threadIdx.x][w];
    atomicAdd(&a.acc0[threadIdx.x], s);
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
  float m2lr;   // -2 lr
  float decay1;  // 1 - min(lr, 1)
  float min_t;
  float max_t;
  int k0;
  int k1;
  float* dreg;  // [G (1+K) + 1], zero between launches
  unsigned* done;
};

__global__ void sgda_lambda_kernel(Lambda a) {
  extern __shared__ float sh[];  // [G (1+K) + 1] block sums
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int nc = a.K + 1;
  const int nsum = a.G * nc + 1;
  for (int i = threadIdx.x; i < nsum; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b < a.B) {
    const int* rid = a.ids + b * a.P;
    const float* rx = a.vals + b * a.P;
    const float valid = a.valid[b];
    const int64_t ld = nc;
    // the forecast v'_f at an entry, and the entry's mask
    auto v_dash = [&](int p, int f, float* v) {
      const int id = rid[p];
      const int g = a.attr_group[id];
      *v = a.tab[id * ld + 1 + f];
      const float rv = a.reg_v[g * a.K + f];
      return *v - a.lr * (a.grad_tab[id * ld + 1 + f] + 2.f * rv * *v);
    };
    auto mask = [&](int p) { return rx[p] != 0.f ? valid : 0.f; };
    float part = 0.f;
    for (int f = lane; f < a.K; f += 32) {
      float s = 0.f, s2 = 0.f;
      for (int p = 0; p < a.P; ++p) {
        float v;
        const float d = v_dash(p, f, &v) * rx[p] * mask(p);
        s += d;
        s2 += d * d;
      }
      part += 0.5f * (s * s - s2);
    }
    part = svbfm::warp_sum(part);
    float pr = a.k0 ? *a.w0 : 0.f;
    if (a.k1) {
      float sw = 0.f;
      for (int p = 0; p < a.P; ++p) {
        const int id = rid[p];
        const float w = a.tab[id * ld];
        const float rw = a.reg_w[a.attr_group[id]];
        const float wd = w - a.lr * (a.grad_tab[id * ld] + 2.f * rw * w);
        sw += wd * rx[p] * mask(p);
      }
      pr += sw;
    }
    pr += part;
    const float gl =
        2.f * (clip_nan(pr, a.min_t, a.max_t) - a.y[b]) * valid;
    // per-group sums within the row, each group's from its first entry
    auto first_of_group = [&](int p, int* g) {
      if (mask(p) == 0.f) return false;
      *g = a.attr_group[rid[p]];
      for (int q = 0; q < p; ++q)
        if (mask(q) != 0.f && a.attr_group[rid[q]] == *g) return false;
      return true;
    };
    // JAX sums every group of every row: a group the row does not touch
    // adds gl * (-2 lr) * 0, which is NaN when gl is not finite, and the
    // v terms' sfd * 0 is NaN when sfd is not finite
    if (!isfinite(gl)) {
      for (int i = lane; i < a.G * nc; i += 32)
        atomicAdd(&sh[i], quiet_nan());
    }
    if (lane == 0) {
      atomicAdd(&sh[a.G * nc], valid);
      for (int p = 0; p < a.P; ++p) {
        int g;
        if (!first_of_group(p, &g)) continue;
        float lw = 0.f;
        for (int q = p; q < a.P; ++q)
          if (mask(q) != 0.f && a.attr_group[rid[q]] == g)
            lw += rx[q] * a.tab[rid[q] * ld] * mask(q);
        atomicAdd(&sh[g * nc], gl * a.m2lr * lw);
      }
    }
    for (int f = lane; f < a.K; f += 32) {
      float sfd = 0.f;
      for (int p = 0; p < a.P; ++p) {
        float v;
        sfd += rx[p] * v_dash(p, f, &v) * mask(p);
      }
      if (!isfinite(sfd)) {
        for (int g = 0; g < a.G; ++g)
          atomicAdd(&sh[g * nc + 1 + f], quiet_nan());
      }
      for (int p = 0; p < a.P; ++p) {
        int g;
        if (!first_of_group(p, &g)) continue;
        float sf = 0.f, sfdf = 0.f;
        for (int q = p; q < a.P; ++q) {
          if (mask(q) == 0.f || a.attr_group[rid[q]] != g) continue;
          float v;
          const float xvd = rx[q] * v_dash(q, f, &v) * mask(q);
          sf += rx[q] * v * mask(q);
          sfdf += xvd * v * rx[q] * mask(q);
        }
        atomicAdd(&sh[g * nc + 1 + f], gl * (a.m2lr * (sfd * sf - sfdf)));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nsum; i += blockDim.x)
    if (sh[i] != 0.f) atomicAdd(&a.dreg[i], sh[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every block's sums are in dreg
  __threadfence();
  const float n_v = __ldcg(&a.dreg[a.G * nc]);
  const float scale_l =
      (1.f - powf(a.decay1, n_v)) / (a.lr * fmaxf(n_v, 1.f));
  const float ls = a.lr * scale_l;
  for (int i = threadIdx.x; i < a.G * nc; i += blockDim.x) {
    const int g = i / nc, c = i % nc;
    float* r = c == 0 ? &a.reg_w[g] : &a.reg_v[g * a.K + c - 1];
    *r = max0_nan(*r - ls * __ldcg(&a.dreg[i]));
    a.dreg[i] = 0.f;
  }
  if (threadIdx.x == 0) {
    a.dreg[a.G * nc] = 0.f;
    *a.done = 0u;
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
  sgd_grad_scatter_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(a);
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

// X9c.  At least one block runs, so the reg step happens on an empty batch.
SVBFM_EXPORT int svbfm_sgda_lambda(
    const float* tab, const float* grad_tab, int K, const float* w0,
    float* reg_w, float* reg_v, const int* attr_group, int G, const int* ids,
    const float* vals, const float* y, const float* valid, int64_t B, int P,
    float lr, float m2lr, float decay1, float min_t, float max_t, int k0, int k1,
    float* dreg, unsigned* done, cudaStream_t stream) {
  Lambda a{tab, grad_tab, K, w0, reg_w, reg_v, attr_group, G, ids, vals, y,
           valid, B, P, lr, m2lr, decay1, min_t, max_t, k0, k1, dreg, done};
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * (K + 1) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sgda_lambda_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = B > 0 ? warp_blocks(B) : 1;
  sgda_lambda_kernel<<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
