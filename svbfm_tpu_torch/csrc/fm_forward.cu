// K1: FM score and VBFM T-term forward over the padded row layout; in its
// relations mode, X10d's block-structure scores (bs_scores, below); with an
// output epilogue, the serving path's scores (svbfm_fm_serve); over one
// feature shard, T1's partial sums (tp_partials_kernel), and T12, their
// finalize with the serve epilogue (tp_serve_kernel, at the end).
//
// Replaces svbfm_tpu/ops/forward.py:fm_scores and :fm_t_terms (XLA gather
// chains).  Per row n of ids/vals [N, P]:
//   score = w0 + sum_p w x + 1/2 sum_f [(sum_p v x)^2 - sum_p (v x)^2]
//   T     = s0 + sum_p sw x^2
//           + sum_f [1/2 z^2 + z q2 - sum_p (m^2 x^4 s + 1/2 x^4 s^2)]
//   with q2 = sum_p (m x)^2, z = sum_p s x^2.
//
// Layout: the parameter tables arrive channel-stacked, row-major at any row
// stride ld, [D, 1+K] (w, v) or [D, 1+2K] (sw, m, s).  ops/forward.py
// builds them with three pad floats ahead of each row and the stride
// rounded up to 4 floats ((pad | w | v^T | pad), 24 floats at K = 20;
// (pad | sw | m^T | s^T | pad), 44), so that the factor channels start on
// 16-byte boundaries; the SGD family hands its own [D, 1+K] table (stride
// 21 at K = 20) straight in.
//
// Bound: memory, but not DRAM: each row reads P ids and values (8 bytes a
// position, streamed) and gathers P table rows at random (the table,
// 1-2 MB at the ML-1M shape, stays in L2), so what costs is the gathers'
// L2 sectors (3 a position at a 96-byte row, 6 at 176 bytes) and the
// rows in flight.  The form (X8b's, mcmc_sweep.cu:row_patch_wide_kernel):
// a row's factors in chunks of 4, TPR = min(ceil(K / 4), 32) lanes a row
// (lane j owning chunks j, j + 32, ...), 32 / TPR rows a warp (5 lanes and
// 6 rows at K = 20); a chunk is read in one 16-byte load where K, the
// table's base and its stride allow, else in 4-byte loads, so the
// unaligned SGD table keeps the layout with narrower loads.  A row's
// ids and x are read once, every position's table pieces are issued
// before the first FMA, the linear channel (w or sw) rides on the row's
// first lane beside its chunk, and the lanes' sums meet by a segmented
// shuffle in a fixed order, with no shared memory and no barrier.  kP = 2
// builds the kernel for rows of two positions (ML-1M's rows hold a user
// and an item), so its loops unroll whole; kP = 0 takes any P, kPos
// positions at a time.  (The TPU version's per-position flat gathers,
// which dodged the TPU's (8,128) tile padding, are not carried over.
// Measured on the H100: 8-factor chunks ran K1a on the train rows 8 %
// faster and K1b 19 % slower, for its registers; blocks of 8 warps ran
// K1b 5 % slower; capping the registers at 40 or 32 spilled; on rows of
// two positions the any-P build ran K1a 36 % and K1b 68 % slower than the
// kP = 2 build, at 58-94 registers against 36-55.)
//
// X10d's joined scores (bs_scores, replacing svbfm_tpu/learners/
// mcmc_bs.py:bs_scores, :215-268) are this kernel in its relations mode:
//   y = w0 + sum_p w x + sum_r lin_r[j_r]
//       + 1/2 [sum_f s_f^2 - sum_p sum_f (v_f x)^2 - sum_r sumsB_r[j_r]],
//   s_f = sum_p v_f x + sum_r qB_r,f[j_r],
// the main positions read from stab [D_all, 1+K] at its row stride in
// 4-byte loads, each relation's moments row (qB | lin | sum_f sB,
// kernels/bs_forward.py, at a stride of a multiple of 8 floats: 24 at
// K = 20, three 32-byte sectors) at the joined row.  A relation's qB chunk
// adds into the chunk's s before it is squared; its lin and sum_f sB ride
// on the row's last lane (one 8-byte load beside that lane's chunk, in
// the same sector); the joins of kRelBatch relations are loaded, then
// every relation's pieces before the first add; all of a row sums in the
// one segmented shuffle.  What bounds it is the moments rows' L2 sectors,
// as K1's table rows, and the rows an SM holds in flight.  kP = 1 builds
// it for the block-structure recipes' main block (empty, padded to one
// position).  (The earlier form, a warp a row with lanes over the
// factors, each relation a serial chain of loads and lane 0 summing the
// linear terms alone, ran 0.53 ms on 1M rows with two relations.
// Measured on the H100, 1M rows: batches of four relations ran 0.085 ms
// with two relations, 23 % slower, at 62-80 registers; one relation at a
// time 0.070 ms, and 14 % slower with nine; the row's joins loaded one a
// lane and handed on by shuffle 0.086 ms (the select of a held join
// costs registers); capping the registers at 40 or 32 put arrays on the
// stack and ran 1.1-2.3x slower; on rows of one position the any-P build
// ran 47 % slower than the kP = 1 build, at 74 registers against 48.)
#include <algorithm>
#include <type_traits>

#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps: the SMs refill sooner than with 8
constexpr int kChunk = 4;  // factors a lane takes a pass
constexpr int kPos = 4;    // positions whose loads go out together (any P)
constexpr int kRelBatch = 2;  // relations whose loads go out together

// The 4 factors of chunk f0 at p, in loads of W floats; those at or past
// K (the last chunk where K % 4 != 0, read at W = 1) read as 0.
template <int W>
__device__ __forceinline__ void load_chunk(const float* p, int n_in,
                                           float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; i += W) {
    if (i < n_in) {
      float t[W];
      svbfm::load_vec<W>(p + i, t);
#pragma unroll
      for (int k = 0; k < W; ++k) v[i + k] = t[k];
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[i + k] = 0.f;
    }
  }
}

// One row's position pieces: the chunk's v (scores) or m and s (T-terms)
// and the linear channel.
template <bool kT>
struct Pieces {
  float a[kChunk];             // v or m
  float b[kT ? kChunk : 1];    // s (T-terms)
  float lin;                   // w or sw
};

// Adds one position (value x) to the chunk's factor sums, in the twin's
// formulas.
template <bool kT>
__device__ __forceinline__ void add_factors(const Pieces<kT>& g, float x,
                                            float (&s)[kChunk],
                                            float (&s2)[kChunk],
                                            float (&s3)[kChunk]) {
  if constexpr (kT) {
    const float x2 = x * x;
    const float x4 = x2 * x2;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float m = g.a[k], sv = g.b[k];
      const float mx = m * x;
      s[k] += mx * mx;   // q2
      s2[k] += sv * x2;  // z
      s3[k] += m * m * x4 * sv + 0.5f * x4 * sv * sv;  // neg
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float d = g.a[k] * x;
      s[k] += d;
      s2[k] += d * d;
    }
  }
}

// The relations of the block-structure scores (bs_scores): a data row n
// joins row joins[r][n] of relation r's moments table moms[r], rows
// (qB | lin | sum_f sB) at stride ld (kernels/bs_forward.py); joins and
// moms are device arrays of n pointers.
struct Relations {
  int n;
  const int* const* joins;
  const float* const* moms;
  int64_t ld;
};

// Adds the relations' terms to one chunk of a data row: every relation's
// qB chunk into s, and, on the rider (the row's last chunk), each lin into
// lr and each sum_f sB into sb.  The relations come kRelBatch at a time:
// their joins, then every relation's pieces are loaded before the first
// add.  Each lane loads its row's joins itself: one load instruction
// serves the warp's rows, whose lanes read one address a row.
template <int Wm>
__device__ __forceinline__ void add_relations(
    const Relations& rel, int64_t n, bool valid, bool fac, bool rider,
    int f0, int n_in, int K, float (&s)[kChunk], float& lr, float& sb) {
  for (int r0 = 0; r0 < rel.n; r0 += kRelBatch) {
    int jr[kRelBatch];
#pragma unroll
    for (int b = 0; b < kRelBatch; ++b)
      jr[b] = valid && r0 + b < rel.n ? rel.joins[r0 + b][n] : 0;
    float qb[kRelBatch][kChunk], rr[kRelBatch][2];
#pragma unroll
    for (int b = 0; b < kRelBatch; ++b) {
      rr[b][0] = rr[b][1] = 0.f;
      if (r0 + b < rel.n && (fac || rider)) {
        const float* m =
            rel.moms[r0 + b] + static_cast<int64_t>(jr[b]) * rel.ld;
        if (fac) load_chunk<Wm>(m + f0, n_in, qb[b]);
        if (rider) svbfm::load_vec<2, Wm == 4 ? 2 : 1>(m + K, rr[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kRelBatch; ++b) {
      if (r0 + b < rel.n) {
        if (fac) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) s[k] += qb[b][k];
        }
        lr += rr[b][0];
        sb += rr[b][1];
      }
    }
  }
}

// The serve epilogue's output modes (svbfm_tpu/serve.py:147-155): the
// score as it is, clamped to [lo, hi], or Phi(score).
constexpr int kOutScore = 0, kOutClamp = 1, kOutProbit = 2;

// A score's output in mode kOut.  The clamp keeps a NaN score NaN (as
// jnp.maximum / jnp.minimum do; fmaxf would return the bound) and takes
// +-Inf to the bounds; the host passes -Inf / +Inf for a side whose bound
// is not finite, which then leaves every score as it is.
template <int kOut>
__device__ __forceinline__ float serve_out(float s, float lo, float hi) {
  if constexpr (kOut == kOutClamp) {
    s = s < lo ? lo : s;
    return s > hi ? hi : s;
  } else if constexpr (kOut == kOutProbit) {
    return svbfm::ref_cdf(s);
  } else {
    return s;
  }
}

// Wm = 0: K1 (no relations).  Wm = 4 or 1: bs_scores, the main positions
// read at 4 bytes (W = 1) and each relation's moments row in loads of Wm
// floats.  kOut: the serve epilogue (kOutScore everywhere else; lo and hi
// are read by kOutClamp alone).
template <int W, int kP, bool kT, int Wm, int kOut>
__global__ void __launch_bounds__(kThreads)
    fm_rows_kernel(const float* __restrict__ tab, int64_t ld, int K,
                   const float* __restrict__ base0,
                   const int* __restrict__ ids,
                   const float* __restrict__ vals, int64_t N, int P_any,
                   int TPR, Relations rel, float* __restrict__ out, float lo,
                   float hi) {
  static_assert(Wm == 0 || !kT, "the relations join the scores alone");
  static_assert(kOut == kOutScore || (Wm == 0 && !kT),
                "the serve epilogue follows K1a alone");
  constexpr int kB = kP > 0 ? kP : kPos;  // positions a batch
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
  const int G = (K + kChunk - 1) / kChunk;  // chunks a row
  const int* nid = ids + n * P;
  const float* nx = vals + n * P;
  float part = 0.f, b0 = 0.f;
  int id[kB];
  float xv[kB];
  if (valid && j == 0) b0 = *base0;  // in flight beside the row's loads
  if constexpr (kP > 0) {  // the row's ids and x, once
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      id[b] = valid ? nid[b] : 0;
      xv[b] = valid ? nx[b] : 0.f;
    }
  }
  // lane j's chunks j, j + 32, ... in passes that are the same across the
  // warp (the relations' shuffles need every lane); lane 0's first pass
  // also takes the linear channel, and at K = 0 it is the only pass
  for (int c0 = 0; c0 < G || c0 == 0; c0 += 32) {
    const int ch = c0 + j;
    const bool lin = valid && ch == 0;
    const bool fac = valid && ch < G;
    const int f0 = ch * kChunk;
    const int n_in = K - f0;
    float s[kChunk], s2[kChunk], s3[kChunk], l = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) s[k] = s2[k] = s3[k] = 0.f;
    for (int p0 = 0; (lin || fac) && p0 < P; p0 += kB) {
      if constexpr (kP == 0) {
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const bool in = p0 + b < P;
          id[b] = in ? nid[p0 + b] : 0;
          xv[b] = in ? nx[p0 + b] : 0.f;
        }
      }
      Pieces<kT> g[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (kP > 0 || p0 + b < P) {
          const float* row = tab + static_cast<int64_t>(id[b]) * ld;
          g[b].lin = lin ? row[0] : 0.f;
          if (fac) {
            load_chunk<W>(row + 1 + f0, n_in, g[b].a);
            if constexpr (kT) load_chunk<W>(row + 1 + K + f0, n_in, g[b].b);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (kP > 0 || p0 + b < P) {
          const float x = xv[b];
          l += g[b].lin * (kT ? x * x : x);  // 0 off the linear lane
          if (fac) add_factors<kT>(g[b], x, s, s2, s3);
        }
      }
    }
    if constexpr (Wm > 0) {
      // lin and sum_f sB of each relation ride on the row's last chunk
      const bool rider = valid && ch == (G > 0 ? G - 1 : 0);
      float lr = 0.f, sb = 0.f;
      add_relations<Wm>(rel, n, valid, fac, rider, f0, n_in, K, s, lr, sb);
      if (rider) part += K > 0 ? lr - 0.5f * sb : lr;  // as the twin
    }
    if (fac) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        part += kT ? 0.5f * s2[k] * s2[k] + s2[k] * s[k] - s3[k]
                   : 0.5f * (s[k] * s[k] - s2[k]);
      }
    }
    if (lin) part += l;
  }
  for (int d = 1; d < TPR; d <<= 1) {
    const float t = __shfl_down_sync(svbfm::kFullMask, part, d);
    if (j + d < TPR) part += t;
  }
  if (valid && j == 0) out[n] = serve_out<kOut>(b0 + part, lo, hi);
}

// The loads' width (mirrored by kernels/fm_forward.py:fm_plan): 4 floats
// where K and ld are multiples of 4 and the factor channels' base, tab + 1,
// is 16-byte aligned (the tables ops/forward.py builds), else 1.
int load_width(const float* tab, int64_t ld, int K) {
  const bool wide = K > 0 && K % 4 == 0 && ld % 4 == 0 &&
                    svbfm::aligned(tab + 1, 16);
  return wide ? 4 : 1;
}

// The moments rows' load width in bs_scores (mirrored by
// kernels/bs_forward.py:scores_plan): 4 floats where K and the rows'
// stride are multiples of 4 and every table's base is 16-byte aligned
// (``aligned``: the wrapper reads the bases, which sit in a device
// array here), else 1.
int moments_width(int K, int64_t ldm, int aligned) {
  return K > 0 && K % 4 == 0 && ldm % 4 == 0 && aligned ? 4 : 1;
}

// Lanes a row (mirrored by kernels/fm_forward.py:fm_plan).
int row_lanes(int K) {
  return std::max(1, std::min((K + kChunk - 1) / kChunk, 32));
}

// W: the main table's load width; Wm: the moments' (0: no relations);
// kOut: the output mode.
template <bool kT, int W, int Wm, int kOut = kOutScore>
int launch(const float* tab, int64_t ld, int K, const float* base0,
           const int* ids, const float* vals, int64_t N, int P,
           const Relations& rel, float* out, cudaStream_t stream,
           float lo = 0.f, float hi = 0.f) {
  const int TPR = row_lanes(K);
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  // K1 has a build for rows of two positions (ML-1M's), the relations
  // mode one for rows of one (the block-structure recipes' main block:
  // empty, padded to P = 1)
  auto kernel = fm_rows_kernel<W, 0, kT, Wm, kOut>;
  if constexpr (Wm == 0) {
    if (P == 2) kernel = fm_rows_kernel<W, 2, kT, 0, kOut>;
  } else {
    if (P == 1) kernel = fm_rows_kernel<W, 1, kT, Wm, kOut>;
  }
  kernel<<<blocks, kThreads, 0, stream>>>(tab, ld, K, base0, ids, vals, N, P,
                                          TPR, rel, out, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <bool kT>
int launch_fm(const float* tab, int64_t ld, int K, const float* base0,
              const int* ids, const float* vals, int64_t N, int P, float* out,
              cudaStream_t stream) {
  const Relations none{0, nullptr, nullptr, 0};
  return load_width(tab, ld, K) == 4
             ? launch<kT, 4, 0>(tab, ld, K, base0, ids, vals, N, P, none, out,
                                stream)
             : launch<kT, 1, 0>(tab, ld, K, base0, ids, vals, N, P, none, out,
                                stream);
}

template <int kOut>
int launch_serve(const float* tab, int64_t ld, int K, const float* w0,
                 const int* ids, const float* vals, int64_t N, int P,
                 float lo, float hi, float* out, cudaStream_t stream) {
  const Relations none{0, nullptr, nullptr, 0};
  return load_width(tab, ld, K) == 4
             ? launch<false, 4, 0, kOut>(tab, ld, K, w0, ids, vals, N, P,
                                         none, out, stream, lo, hi)
             : launch<false, 1, 0, kOut>(tab, ld, K, w0, ids, vals, N, P,
                                         none, out, stream, lo, hi);
}

// T1: K1's partial sums over one feature shard (svbfm_tpu/parallel/
// tp_vb.py:tp_scores, :tp_t_terms; parallel/tp.py:make_tp_scorer.scorer).
// The table holds the shard's ids [lo, lo + D_loc) at local rows 0 ..
// D_loc - 1; an id outside the window adds nothing and reads no table row.
// A row's partials are written, not its score: out [N, CH] at row stride
// CH = 1 + 2K, (lin | s_f | s2_f), or 1 + 3K for the T-terms, (lin | q2_f |
// z_f | neg_f).  The square of s_f, and z_f^2 and z_f q2_f, are taken after
// the partials of every shard have been summed (the feature all-reduce),
// by the finalize in parallel/tp.py.  K1's lane form: TPR = min(ceil(K /
// 4), 32) lanes a row, lane j owning chunks j, j + TPR, ... of 4 factors
// read in loads of W floats (load_width), the linear channel on the
// chunk-0 lane; each lane writes its own chunks' sums, so no lane waits on
// another and there is no shuffle.
template <int W, bool kT>
__global__ void __launch_bounds__(kThreads)
    tp_partials_kernel(const float* __restrict__ tab, int64_t ld, int K,
                       int64_t lo, int D_loc, const int* __restrict__ ids,
                       const float* __restrict__ vals, int64_t N, int P,
                       int TPR, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / TPR;  // rows a warp
  const int slot = lane / TPR;
  const int j = lane - slot * TPR;
  const int64_t n =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
          rpw + slot;
  if (slot >= rpw || n >= N) return;
  const int G = (K + kChunk - 1) / kChunk;  // chunks a row
  const int64_t CH = 1 + (kT ? 3 : 2) * static_cast<int64_t>(K);
  const int* nid = ids + n * P;
  const float* nx = vals + n * P;
  float* orow = out + n * CH;
  for (int ch = j; ch < G || ch == 0; ch += TPR) {
    const bool lin = ch == 0;
    const bool fac = ch < G;
    const int f0 = ch * kChunk;
    const int n_in = K - f0;
    float s[kChunk], s2[kChunk], s3[kChunk], l = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) s[k] = s2[k] = s3[k] = 0.f;
    for (int p = 0; p < P; ++p) {
      const int64_t loc = static_cast<int64_t>(nid[p]) - lo;
      if (loc < 0 || loc >= D_loc) continue;  // another shard's id
      const float x = nx[p];
      const float* row = tab + loc * ld;
      if (lin) l += row[0] * (kT ? x * x : x);
      if (fac) {
        Pieces<kT> g;
        load_chunk<W>(row + 1 + f0, n_in, g.a);
        if constexpr (kT) load_chunk<W>(row + 1 + K + f0, n_in, g.b);
        add_factors<kT>(g, x, s, s2, s3);
      }
    }
    if (lin) orow[0] = l;
    if (fac) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < n_in) {
          orow[1 + f0 + k] = s[k];
          orow[1 + K + f0 + k] = s2[k];
          if constexpr (kT) orow[1 + 2 * K + f0 + k] = s3[k];
        }
      }
    }
  }
}

template <bool kT>
int launch_tp_partials(const float* tab, int64_t ld, int K, int64_t lo,
                       int D_loc, const int* ids, const float* vals,
                       int64_t N, int P, float* out, cudaStream_t stream) {
  const int TPR = row_lanes(K);
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  auto kernel = load_width(tab, ld, K) == 4 ? tp_partials_kernel<4, kT>
                                            : tp_partials_kernel<1, kT>;
  kernel<<<blocks, kThreads, 0, stream>>>(tab, ld, K, lo, D_loc, ids, vals,
                                          N, P, TPR, out);
  return static_cast<int>(cudaGetLastError());
}

// T12: the feature-sharded scorer's finalize with the serve epilogue
// (svbfm_tpu/serve.py:129-136 and :147-155): from T1's partials part
// [N, 1 + 2K] summed over the shards, out[n] = serve_out<kOut>(lin +
// 1/2 sum_f (s_f^2 - s2_f) + w0), the square after the sum.  A warp a row,
// lanes over the factors, their terms summed by a shuffle; lane 0 writes.
template <int kOut>
__global__ void __launch_bounds__(kThreads)
    tp_serve_kernel(const float* __restrict__ part, int K,
                    const float* __restrict__ w0, int64_t N, float lo,
                    float hi, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (n >= N) return;  // the whole warp leaves together
  const float* row = part + n * (1 + 2 * static_cast<int64_t>(K));
  float q = 0.f;
  for (int f = lane; f < K; f += 32) {
    const float s = row[1 + f];
    q += s * s - row[1 + K + f];
  }
  q = svbfm::warp_sum(q);
  if (lane == 0) out[n] = serve_out<kOut>(row[0] + 0.5f * q + *w0, lo, hi);
}

template <int kOut>
int launch_tp_serve(const float* part, int K, const float* w0, int64_t N,
                    float lo, float hi, float* out, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((N * 32 + kThreads - 1) / kThreads);
  tp_serve_kernel<kOut><<<blocks, kThreads, 0, stream>>>(part, K, w0, N, lo,
                                                         hi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab [D, 1+K] = (w | v^T) at row stride ld; w0 a device scalar; out [N]
SVBFM_EXPORT int svbfm_fm_scores(const float* tab, int64_t ld, int K,
                                 const float* w0, const int* ids,
                                 const float* vals, int64_t N, int P,
                                 float* out, cudaStream_t stream) {
  return launch_fm<false>(tab, ld, K, w0, ids, vals, N, P, out, stream);
}

// tab [D, 1+2K] = (sw | m^T | s^T) at row stride ld; s0 a device scalar;
// out [N]
SVBFM_EXPORT int svbfm_fm_t_terms(const float* tab, int64_t ld, int K,
                                  const float* s0, const int* ids,
                                  const float* vals, int64_t N, int P,
                                  float* out, cudaStream_t stream) {
  return launch_fm<true>(tab, ld, K, s0, ids, vals, N, P, out, stream);
}

// bs_scores [N]: the joined score of each data row, from the main rows
// ids/vals [N, P] over stab [D_all, 1+K] = (w | v^T) at row stride ld and
// nrel relations (joins: a device array of nrel pointers to int [N];
// moms: of nrel pointers to moments tables [R_r, K+2] at row stride ldm;
// moms_aligned: whether every table's base is 16-byte aligned).  K1a's
// kernel in its relations mode (see the top and add_relations).
SVBFM_EXPORT int svbfm_bs_scores(const float* stab, int64_t ld, int K,
                                 const float* w0, const int* ids,
                                 const float* vals, int64_t N, int P,
                                 int nrel, const int* const* joins,
                                 const float* const* moms, int64_t ldm,
                                 int moms_aligned, float* out,
                                 cudaStream_t stream) {
  if (nrel < 0 || ldm < K + 2) return static_cast<int>(cudaErrorInvalidValue);
  const Relations rel{nrel, joins, moms, ldm};
  return moments_width(K, ldm, moms_aligned) == 4
             ? launch<false, 1, 4>(stab, ld, K, w0, ids, vals, N, P, rel, out,
                                   stream)
             : launch<false, 1, 1>(stab, ld, K, w0, ids, vals, N, P, rel, out,
                                   stream);
}

// The serving path's scores (svbfm_tpu/serve.py:125-155): K1a's kernel with
// its output epilogue, mode 0 the scores, 1 the scores clamped to [lo, hi]
// (-Inf / +Inf for an open side), 2 Phi(score); tab, w0, ids, vals and out
// as svbfm_fm_scores.
SVBFM_EXPORT int svbfm_fm_serve(const float* tab, int64_t ld, int K,
                                const float* w0, const int* ids,
                                const float* vals, int64_t N, int P, int mode,
                                float lo, float hi, float* out,
                                cudaStream_t stream) {
  switch (mode) {
    case kOutScore:
      return launch_serve<kOutScore>(tab, ld, K, w0, ids, vals, N, P, lo, hi,
                                     out, stream);
    case kOutClamp:
      return launch_serve<kOutClamp>(tab, ld, K, w0, ids, vals, N, P, lo, hi,
                                     out, stream);
    case kOutProbit:
      return launch_serve<kOutProbit>(tab, ld, K, w0, ids, vals, N, P, lo,
                                      hi, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// T1: the partials [N, 1 + 2K] (t_terms = 0: lin | s | s2, from tab [D_loc,
// 1+K] = (w | v^T)) or [N, 1 + 3K] (t_terms = 1: lin | q2 | z | neg, from
// tab [D_loc, 1+2K] = (sw | m^T | s^T)) of rows ids/vals [N, P] over the
// ids of one feature shard [lo, lo + D_loc), tab at row stride ld.
SVBFM_EXPORT int svbfm_tp_fm_partials(const float* tab, int64_t ld, int K,
                                      int t_terms, int64_t lo, int D_loc,
                                      const int* ids, const float* vals,
                                      int64_t N, int P, float* out,
                                      cudaStream_t stream) {
  return t_terms ? launch_tp_partials<true>(tab, ld, K, lo, D_loc, ids, vals,
                                            N, P, out, stream)
                 : launch_tp_partials<false>(tab, ld, K, lo, D_loc, ids,
                                             vals, N, P, out, stream);
}

// T12: predictions out [N] from the partials part [N, 1 + 2K] (lin | s |
// s2) summed over the feature shards and w0 (a device scalar, 0 with k0
// off); mode and lo/hi as svbfm_fm_serve's.
SVBFM_EXPORT int svbfm_tp_serve(const float* part, int K, const float* w0,
                                int64_t N, int mode, float lo, float hi,
                                float* out, cudaStream_t stream) {
  if (N == 0) return 0;
  switch (mode) {
    case kOutScore:
      return launch_tp_serve<kOutScore>(part, K, w0, N, lo, hi, out, stream);
    case kOutClamp:
      return launch_tp_serve<kOutClamp>(part, K, w0, N, lo, hi, out, stream);
    case kOutProbit:
      return launch_tp_serve<kOutProbit>(part, K, w0, N, lo, hi, out,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
