// K2-K4: one factor block of the batch VBFM coordinate sweep: fast mode
// (all K factors in one block, the linear-term update riding along) or
// exact mode (blocks of factor_block factors).  K2 and K4 also serve the
// online VB factor sweep (vb_online.py:444 _qtz_generic, :561-580), whose
// column statistics are K6 (ovb_sweep.cu).  K2's q channel alone is X8d,
// the q cache of the MCMC/ALS sweep (mcmc_sweep.cu), and K4 at F = 0 is
// also MCMC's w patch (with no t cache).  T2-T4, the feature-sharded
// sweep's kernels, are at the end, with T6, T2's q-only mode (the
// feature-sharded Gibbs/ALS's q cache).
//
// Replaces svbfm_tpu/learners/vb.py:vb_v_block_update, whose three XLA
// gather chains are
//   K2 build_qt   (vb.py:317-332)  row caches q, tq, tz;
//   K3 tile_stats (vb.py:382-405) + the closed-form update (vb.py:449-487)
//                                  per-column statistics of one [C, L] bucket;
//   K4 patch_tile (vb.py:508-568)  the per-bin row-cache patch; at F = 0
//                                  it is also the w patch of the standalone
//                                  linear-term sweep (vb.py:149-157,
//                                  vb_online.py:270-282).
//
// Layouts.  Row caches q/tq/tz are [N, F] row-major (the JAX package keeps
// [F, N] for the TPU's (8,128) tiling): one row's F factors are one
// contiguous run, and rows n..n+R of a cache are one contiguous run of R*F
// floats.  mu/sigma tables are [D, F].  The per-bin patch table ptab is
// [D, CH], CH = 5F (+2 with the w rider), channels (mu_old, sig_old, dmu,
// dsig, dmu2 [, wdmu, wdsig]); mu_old/sig_old are the PRE-BIN snapshot
// every bucket of the bin and the patch read, so K3 may write the new
// values into mu/sigma in place.
//
// What bounds them on an H100: bytes, and the latency of the loads that
// fetch them.  FLOPs are negligible (a few per byte moved).
//   K3 at F = 20 gathers an 80-byte q and tq row at a data-dependent row
//   per entry: random 32-byte HBM sectors (3 for 80 bytes), behind a
//   dependent row-id load.  At F = 1, q, tq and e (4 MB each at ML-1M) stay
//   in L2, and every 4-byte gather moves a 32-byte sector out of it.
//   K4 streams the [N, F] caches in and out of HBM and gathers a ptab row
//   (4 MB at ML-1M: it stays in L2) per row and position.
// So every lane keeps wide loads in flight: lanes map to (entry or row,
// factor chunk) pairs, a chunk being V = 4 factors (16-byte loads) where F
// and the pointers allow; the next loads are issued before the arithmetic
// that waits on the current ones; and the sums over a chunk's lanes are
// taken in shared memory in a fixed order (no float atomics: a run repeats
// bit for bit).  64-bit offsets for row * channel arithmetic.
#include <type_traits>

#include "svbfm_common.cuh"

namespace {

using svbfm::aligned;
using svbfm::ceil_div;
using svbfm::chunk_width;
using svbfm::load_vec;
using svbfm::store_vec;

// ---- K2: q = q0 + sum_p mu x, tq = sum_p sig x^2, tz = sum_p mu^2 x^2 ----
// kQOnly builds q alone (X8d, the MCMC/ALS q cache, mcmc.py:337-359 and
// :824-826): tq and tz are neither computed nor written; q0, where given,
// is q's starting value (the block-structure learner's relation part of
// the cache, mcmc.py:344-348: JAX adds the positions onto it).
//
// Bound: bytes (the caches written, 80 MB a cache at N = 1M, F = 20) and
// the gathers' L2 sectors (the patch table, 0.8-4 MB, stays in L2).  The
// form at F >= 2 is X8b's (mcmc_sweep.cu:row_patch_wide_kernel): TPR =
// min(F / V, 32) lanes a row over its chunks of V factors, 32 / TPR rows
// a warp (5 lanes, 6 rows at F = 20 on X8d's [D, 2F] table; 10 lanes, 3
// rows on K2's fast-mode [D, 5F + 2], whose stride admits V = 2); a row's
// ids and x are loaded once, a position a lane, and handed on by shuffle
// (row_share); every position's mu (and sig) chunk is loaded before
// the first FMA; q, tq and tz are stored as V-float vectors.  kP = 2
// builds it for rows of two positions (ML-1M's), kP = 0 for any P,
// kQtPos positions at a time.  At F = 1 a thread takes a row
// (build_qt_f1_kernel).  (The earlier form, a thread a (row, factor),
// reloaded a row's ids and x in every thread, gathered 4 bytes a channel
// and waited on each position's loads in turn: 0.1195 ms for X8d at N =
// 1M, F = 20; 0.0033 ms for K2 on an OVB chunk of 50,002 rows at F = 1.
// Measured on the H100: each lane loading the row's ids and x itself, in
// place of the shuffles, ran X8d at F = 20 5 % and K2 2 % slower; two
// rows a thread at F = 1, with 16-byte loads of their ids and x, ran K2
// on the train rows 14 % slower and no faster on an OVB chunk; on rows of
// two positions the any-P builds ran X8d and K2 at F = 20 about twice as
// long as the kP = 2 builds, X8d and K2 at F = 1 on 1M rows 6-9 % longer,
// and K2 on an OVB chunk the same.)
constexpr int kQtThreads = 128;    // F >= 2 (256 ran 2 % slower)
constexpr int kQtF1Threads = 256;  // F = 1 (128 ran X8d 15 % slower)
constexpr int kQtPos = 4;  // positions whose loads go out together (any P)

// kB values of one row loaded once and handed to every lane of the row: the
// row's TPR lanes start at lane slot * TPR of the warp, lane j loads items
// j, j + TPR, ... through load(b) (one load instruction serves the first
// TPR items of every row of the warp), and item b comes by shuffle from
// lane b % TPR of the row.  Every lane of the warp must call it.
template <int kB, typename T, typename Load>
__device__ __forceinline__ void row_share(int j, int TPR, int slot,
                                          T (&out)[kB], Load load) {
  T hold[kB];
#pragma unroll
  for (int h = 0; h < kB; ++h) {
    const int b = j + h * TPR;
    hold[h] = b < kB ? load(b) : T(0);
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    int h = 0;  // b / TPR, the same in every lane
#pragma unroll
    for (int i = 1; i < kB; ++i) h += b >= i * TPR;
    T v = hold[0];
#pragma unroll
    for (int i = 1; i < kB; ++i) v = i == h ? hold[i] : v;
    out[b] = __shfl_sync(svbfm::kFullMask, v, slot * TPR + b - h * TPR);
  }
}

template <int V, int kP, bool kQOnly>
__global__ void __launch_bounds__(kQtThreads)
    build_qt_rows_kernel(const float* __restrict__ ptab, int64_t ld, int F,
                         const int* __restrict__ ids,
                         const float* __restrict__ vals, int64_t N,
                         int P_any, int TPR, const float* __restrict__ q0,
                         float* __restrict__ q, float* __restrict__ tq,
                         float* __restrict__ tz) {
  constexpr int kB = kP > 0 ? kP : kQtPos;  // positions a batch
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
  const int C = F / V;  // chunks a row
  const int* nid = ids + n * P;
  const float* nx = vals + n * P;
  // lane j's chunks j, j + 32, ... in passes that are the same across the
  // warp (the shuffles need every lane)
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int ch = c0 + j;
    const bool on = valid && ch < C;
    const int64_t o = n * F + ch * V;
    float qa[V], tqa[V], tza[V];
#pragma unroll
    for (int k = 0; k < V; ++k) qa[k] = tqa[k] = tza[k] = 0.f;
    if (on && q0 != nullptr) load_vec<V>(q0 + o, qa);
    for (int p0 = 0; p0 < P; p0 += kB) {
      int id[kB];
      float xv[kB];
      row_share<kB>(j, TPR, slot, id, [&](int b) {
        return valid && p0 + b < P ? nid[p0 + b] : 0;
      });
      row_share<kB>(j, TPR, slot, xv, [&](int b) {
        return valid && p0 + b < P ? nx[p0 + b] : 0.f;
      });
      float mu[kB][V], sg[kB][kQOnly ? 1 : V];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (on && (kP > 0 || p0 + b < P)) {
          const float* row =
              ptab + static_cast<int64_t>(id[b]) * ld + ch * V;
          load_vec<V>(row, mu[b]);
          if constexpr (!kQOnly) load_vec<V>(row + F, sg[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (on && (kP > 0 || p0 + b < P)) {
          const float x = xv[b];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            qa[k] += mu[b][k] * x;
            if constexpr (!kQOnly) {
              const float x2 = x * x;
              tqa[k] += sg[b][k] * x2;
              tza[k] += mu[b][k] * mu[b][k] * x2;
            }
          }
        }
      }
    }
    if (on) {
      store_vec<V>(q + o, qa);
      if constexpr (!kQOnly) {
        store_vec<V>(tq + o, tqa);
        store_vec<V>(tz + o, tza);
      }
    }
  }
}

// K2 at F = 1: a thread a row, mu at channel 0 and sig at channel 1 of its
// ptab rows.  kP = 2: the row's two ids and two x in one 8-byte load each
// (ids and vals 8-byte aligned), both positions' gathers issued together.
template <int kP, bool kQOnly>
__global__ void __launch_bounds__(kQtF1Threads)
    build_qt_f1_kernel(const float* __restrict__ ptab, int64_t ld,
                       const int* __restrict__ ids,
                       const float* __restrict__ vals, int64_t N, int P_any,
                       const float* __restrict__ q0, float* __restrict__ q,
                       float* __restrict__ tq, float* __restrict__ tz) {
  constexpr int kB = kP > 0 ? kP : kQtPos;  // positions a batch
  const int P = kP > 0 ? kP : P_any;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float qa = q0 != nullptr ? q0[n] : 0.f, tqa = 0.f, tza = 0.f;
  for (int p0 = 0; p0 < P; p0 += kB) {
    int id[kB];
    float xv[kB];
    if constexpr (kP == 2) {
      load_vec<2>(ids + n * 2, id);
      load_vec<2>(vals + n * 2, xv);
    } else {
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const bool in = p0 + b < P;
        id[b] = in ? ids[n * P + p0 + b] : 0;
        xv[b] = in ? vals[n * P + p0 + b] : 0.f;
      }
    }
    float mu[kB], sg[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (kP > 0 || p0 + b < P) {
        const float* g = ptab + static_cast<int64_t>(id[b]) * ld;
        mu[b] = g[0];
        if constexpr (!kQOnly) sg[b] = g[1];
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (kP > 0 || p0 + b < P) {
        const float x = xv[b];
        qa += mu[b] * x;
        if constexpr (!kQOnly) {
          const float x2 = x * x;
          tqa += sg[b] * x2;
          tza += mu[b] * mu[b] * x2;
        }
      }
    }
  }
  q[n] = qa;
  if constexpr (!kQOnly) {
    tq[n] = tqa;
    tz[n] = tza;
  }
}

// K2's chunk width at F >= 2 (mirrored by kernels/vb_sweep.py:qt_plan):
// the widest of 4, 2, 1 factors that divides F and ptab's row stride ld
// and to whose size ptab, q0 and the caches are aligned.
int qt_width(int F, int64_t ld, const float* ptab, const float* q0,
             const float* q, const float* tq, const float* tz) {
  int v = chunk_width(F, ptab, q0, q, tq, tz);
  while (v > 1 && ld % v != 0) v /= 2;
  return v;
}

// K2 (kQOnly: X8d) in its form for F, ptab and the caches (see above).
template <bool kQOnly>
int launch_qt(const float* ptab, int64_t ld, int F, const int* ids,
              const float* vals, int64_t N, int P, const float* q0, float* q,
              float* tq, float* tz, cudaStream_t stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaSuccess);
  if (F == 1) {
    const unsigned blocks =
        static_cast<unsigned>((N + kQtF1Threads - 1) / kQtF1Threads);
    const bool p2 = P == 2 && aligned(ids, 8) && aligned(vals, 8);
    auto kernel = p2 ? build_qt_f1_kernel<2, kQOnly>
                     : build_qt_f1_kernel<0, kQOnly>;
    kernel<<<blocks, kQtF1Threads, 0, stream>>>(ptab, ld, ids, vals, N, P,
                                                q0, q, tq, tz);
    return static_cast<int>(cudaGetLastError());
  }
  const int V = qt_width(F, ld, ptab, q0, q, tq, tz);
  const int TPR = F / V < 32 ? F / V : 32;
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kQtThreads - 1) / kQtThreads);
  auto go = [&](auto v) {
    constexpr int kV = decltype(v)::value;
    auto kernel = P == 2 ? build_qt_rows_kernel<kV, 2, kQOnly>
                         : build_qt_rows_kernel<kV, 0, kQOnly>;
    kernel<<<blocks, kQtThreads, 0, stream>>>(ptab, ld, F, ids, vals, N, P,
                                              TPR, q0, q, tq, tz);
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

// ---- K3: per-column statistics + closed-form update of one bucket --------
// (At F <= 4 on buckets of L <= 128: col_stats_lanes_kernel below.)
// One block per column c of the [C, L] bucket (blockIdx.y over groups of GT
// <= kStatChunks factor chunks of V factors).  Lanes map to (entry slot,
// chunk) pairs inside each warp: a warp holds SW = 32 / GT slots of GT
// lanes (6 slots of 5 at F = 20, 2 lanes idle; 32 slots of one lane at
// F = 1), so a slot's lanes read one entry's q/tq chunks, 16 bytes each at
// F % 4 == 0.  The column's row ids and x are staged in shared memory (a
// tile of at most kStatTile entries, one barrier), so a round of
// stat_batch entries a slot waits on one latency: a slot's first lane
// loads the entry's e (once an entry) while every lane gathers its q/tq
// chunks, and the e reaches the other lanes by shuffle.  The rounds are
// the same for the whole block, so no shuffle diverges.  At F = 20 a
// round's 16 gathered floats fit the cap of 64 registers (4 blocks of 256
// threads an SM).  Sums over the slots: a fixed-order
// two-level tree in shared memory; sum x e (the w rider): warp butterflies,
// then the warps in order.  Slot 0's lanes then update their chunks'
// factors.  The bucket's padding entries carry x = 0 (at a real row), so
// they add exactly zero, as in the JAX code: no mask.
//
// X13a, the window-accumulating mode (kWin, the out-of-core batch VB of
// svbfm_tpu/learners/vb_windowed.py:447-518): the bucket is one window's
// [C, L] view of a global column bucket, its rows local to the window, and
// e, q, tq the window's rows of the resident caches (base pointers at the
// window's first row).  Slot 0's lanes take the column's window sums vm,
// vs from the same tree and add them to the [C, 2F] accumulator acc in
// window order: the first window writes them, every later one adds its
// sums to what is there (acc + part, JAX's a + x at :797-798).  Only the
// last window's launch applies the closed form, to the accumulated sums,
// and writes mu/sig and the deltas; the earlier ones write acc alone.  One
// thread writes each (column, factor) of acc: no atomics.  The w rider is
// off in this mode (the windowed learner sweeps w on its own, K5's X13b).
constexpr int kStatChunks = 8;
constexpr int kStatWarps = 8;
constexpr int kStatTile = 512;

// entries a slot a round: 4 gathers of 16 bytes a lane at V = 4, 8 below
template <int V>
__host__ __device__ constexpr int stat_batch() { return V == 4 ? 2 : 4; }

template <int V, bool kWin>
__global__ void __launch_bounds__(32 * kStatWarps, 4)
col_stats_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ sx2, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ tq, int F, int GT,
    float* __restrict__ ptab, int CH, float* __restrict__ mu_t,
    float* __restrict__ sig_t, const float* __restrict__ sv,
    const float* __restrict__ alpha_p, float* __restrict__ mu_w,
    float* __restrict__ sig_w, const float* __restrict__ sigma_w,
    int* __restrict__ nans, float* __restrict__ acc, int win) {
  constexpr int kNV = 2 * V;  // vm, vs of a chunk
  constexpr int kB = stat_batch<V>();
  extern __shared__ float smem[];
  const int nthreads = blockDim.x;
  const int SW = 32 / GT;                 // slots a warp
  const int TS = (nthreads / 32) * SW;    // slots a block
  const int NU = GT * kNV;                // values a slot sums
  const int T = min(L, kStatTile);
  // [T] row ids, [T] x of the tile; [TS NU] the slots' sums; [nthreads]
  // the tree's partials; [32] the warps' sum x e
  int* s_r = reinterpret_cast<int*>(smem);
  float* s_x = smem + T;
  float* red = smem + 2 * T;
  float* part = red + TS * NU;
  float* s_sxe = part + nthreads;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sw = lane / GT;
  const int j = lane - sw * GT;
  const bool on = sw < SW;
  const int lead = sw * GT;  // the slot's first lane
  const int slot = warp * SW + sw;
  const int c = blockIdx.x;
  const int f0 = (blockIdx.y * GT + j) * V;
  const bool active = on && f0 < F;  // F % V == 0: a chunk is in or out
  const int64_t col = cols[c];
  const int g = group[c];
  float* prow = ptab + col * CH;
  float mu_c[V], sig_c[V], vm[V], vs[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu_c[k] = active ? prow[f0 + k] : 0.f;
    sig_c[k] = active ? prow[F + f0 + k] : 0.f;
    vm[k] = vs[k] = 0.f;
  }
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  float sxe = 0.f;
  for (int t0 = 0; t0 < L; t0 += T) {
    const int n = min(T, L - t0);
    for (int i = tid; i < n; i += nthreads) {
      s_r[i] = crow[t0 + i];
      s_x[i] = cx[t0 + i];
    }
    __syncthreads();
    for (int l0 = 0; l0 < n; l0 += kB * TS) {
      bool ok[kB];
      float ev[kB], qv[kB][V], tqv[kB][V];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = l0 + b * TS + slot;
        ok[b] = on && i < n;
        const int rb = ok[b] ? s_r[i] : 0;
        ev[b] = ok[b] && j == 0 ? e[rb] : 0.f;
        if (ok[b] && active) {
          const int64_t o = static_cast<int64_t>(rb) * F + f0;
          load_vec<V, V>(q + o, qv[b]);
          load_vec<V, V>(tq + o, tqv[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float eb = __shfl_sync(svbfm::kFullMask, ev[b], lead);
        if (!ok[b]) continue;
        const float xb = s_x[l0 + b * TS + slot];
        if (j == 0) sxe += xb * eb;
        if (active) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float h = qv[b][k] - xb * mu_c[k];
            const float h1 = tqv[b][k] - xb * xb * sig_c[k];
            vm[k] += xb * h * (eb + xb * mu_c[k] * h);
            vs[k] += xb * xb * (h * h + h1);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites the staging
  }

  // the update's operands, loaded under the reduction's barriers
  const bool updates = warp == 0 && sw == 0 && active;
  const bool rider = mu_w != nullptr && blockIdx.y == 0 && tid == 0;
  float svv[V];
  float alpha = 0.f, wmu_c = 0.f, wsig_c = 0.f, sxx = 0.f, wprior = 0.f;
  if (updates) {
    alpha = *alpha_p;
#pragma unroll
    for (int k = 0; k < V; ++k) svv[k] = sv[g * F + f0 + k];
  }
  if (rider) {
    wmu_c = mu_w[col];
    wsig_c = sig_w[col];
    sxx = sx2[c];
    wprior = sigma_w[g];
  }
  // sums over the slots: value u = j kNV + k of slot s sits at red[s NU + u]
  if (on) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[slot * NU + j * kNV + k] = vm[k];
      red[slot * NU + j * kNV + V + k] = vs[k];
    }
  }
  sxe = svbfm::warp_sum(sxe);
  if (lane == 0) s_sxe[warp] = sxe;
  __syncthreads();
  const int nst = nthreads / NU;  // stripes of slots
  if (tid < nst * NU) {
    const int u = tid % NU;
    const int st = tid / NU;
    float acc = 0.f;
    for (int sl = st; sl < TS; sl += nst) acc += red[sl * NU + u];
    part[st * NU + u] = acc;
  }
  __syncthreads();
  if (updates) {
    int bad = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = j * kNV + k;
      float vmt = 0.f, vst = 0.f;
      for (int st = 0; st < nst; ++st) {
        vmt += part[st * NU + u];
        vst += part[st * NU + u + V];
      }
      const int f = f0 + k;
      if (kWin) {  // win bit 0: the first window; bit 1: the last
        float* arow = acc + static_cast<int64_t>(c) * 2 * F;
        if (!(win & 1)) {
          vmt = arow[f] + vmt;
          vst = arow[F + f] + vst;
        }
        if (!(win & 2)) {
          arow[f] = vmt;
          arow[F + f] = vst;
          continue;
        }
      }
      // vb.py:449-469: sigma' candidate -> count -> keep-finite,
      // mu' = sigma'_kept alpha vm -> count -> keep-finite
      const float sig_cand = 1.f / (svv[k] + alpha * vst);
      bad += isfinite(sig_cand) ? 0 : 1;
      const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c[k];
      const float mu_cand = sig_new * alpha * vmt;
      bad += isfinite(mu_cand) ? 0 : 1;
      const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c[k];
      mu_t[col * F + f] = mu_new;
      sig_t[col * F + f] = sig_new;
      prow[2 * F + f] = mu_new - mu_c[k];
      prow[3 * F + f] = sig_new - sig_c[k];
      prow[4 * F + f] = mu_new * mu_new - mu_c[k] * mu_c[k];
    }
    if (bad) atomicAdd(&nans[0], bad);
  }
  if (rider) {
    // merged linear-term update (vb.py:471-487): the mu candidate uses the
    // kept sigma, the nan count the raw candidates; wdmu = old - new
    float sxe_t = 0.f;
    for (int w = 0; w < nthreads / 32; ++w) sxe_t += s_sxe[w];
    const float wsig_cand = 1.f / (wprior + alpha * sxx);
    const float wsig_new = isfinite(wsig_cand) ? wsig_cand : wsig_c;
    const float wmu_cand = wsig_new * alpha * (sxe_t + wmu_c * sxx);
    const int bad = (isfinite(wsig_cand) ? 0 : 1) + (isfinite(wmu_cand) ? 0 : 1);
    const float wmu_new = isfinite(wmu_cand) ? wmu_cand : wmu_c;
    mu_w[col] = wmu_new;
    sig_w[col] = wsig_new;
    prow[5 * F] = wmu_c - wmu_new;
    prow[5 * F + 1] = wsig_new - wsig_c;
    if (bad) atomicAdd(&nans[1], bad);
  }
}

// K3 and X13a at F <= kStatLanesMaxF on buckets of L <= kStatLanesMaxL
// (the shapes where the form above gives a block one warp, 32 threads an
// SM's block slot: at most half its warps): U lanes a column (stat_lanes:
// the next power of two >= L / kStatLanesSlots, or >= L / 2 where C <
// 2,048, 8 to 32), up to kStatLanesThreads / U columns a block (fewer
// where C is small, at least two warps: svbfm::lanes_block_cols).  Lane li takes slots li, li + U, ... (at most
// kStatLanesSlots; consecutive lanes on consecutive slots): their ids and x
// in registers, then every e, q and tq gather (a slot's F floats of q and
// of tq in loads of V floats: 16 bytes at F = 4), then the FMAs.  vm [F],
// vs [F] (and sum x e with the w rider) close by a butterfly over the
// column's lanes, a fixed order: no staging, no shared-memory tree, no
// barrier.  Padding: svbfm::PadRow (x = 0 slots at the pad row gathered
// once, so a non-finite cache there still reaches the sums).  The
// column's first lane applies the update (or, kWin, adds its sums into acc
// in window order and, at the last window, updates from the totals), with
// the arithmetic of col_stats_kernel.
constexpr int kStatLanesThreads = 256;
constexpr int kStatLanesMaxF = 4;
constexpr int kStatLanesSlots = 4;
constexpr int kStatLanesMaxL = 32 * kStatLanesSlots;

template <int kF, int V, bool kWin>
__global__ void __launch_bounds__(kStatLanesThreads) col_stats_lanes_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int U, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ sx2, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ tq,
    float* __restrict__ ptab, int CH, float* __restrict__ mu_t,
    float* __restrict__ sig_t, const float* __restrict__ sv,
    const float* __restrict__ alpha_p, float* __restrict__ mu_w,
    float* __restrict__ sig_w, const float* __restrict__ sigma_w,
    int* __restrict__ nans, float* __restrict__ acc, int win) {
  constexpr int kS = kStatLanesSlots;
  const int tid = threadIdx.x;
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / U) + tid / U;
  const int li = tid & (U - 1);
  const bool live = c < C;
  const bool rider = mu_w != nullptr;  // never in the window mode
  const bool updates = live && li == 0 && (!kWin || (win & 2));
  float vm[kF], vs[kF], mu_c[kF], sig_c[kF], svv[kF];
  float sxe = 0.f, alpha = 0.f;
  float wmu_c = 0.f, wsig_c = 0.f, sxx = 0.f, wprior = 0.f;
#pragma unroll
  for (int f = 0; f < kF; ++f)
    vm[f] = vs[f] = mu_c[f] = sig_c[f] = svv[f] = 0.f;
  int64_t col = 0;
  float* prow = ptab;
  if (live) {
    col = cols[c];
    prow = ptab + col * CH;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      mu_c[f] = prow[f];
      sig_c[f] = prow[kF + f];
    }
    if (updates) {  // the update's operands, loaded ahead of the gathers
      const int g = group[c];
      alpha = *alpha_p;
#pragma unroll
      for (int f = 0; f < kF; ++f) svv[f] = sv[g * kF + f];
      if (rider) {
        wmu_c = mu_w[col];
        wsig_c = sig_w[col];
        sxx = sx2[c];
        wprior = sigma_w[g];
      }
    }
    const int* crow = rows + c * L;
    const float* cx = x + c * L;
    const svbfm::PadRow pr(crow, cx, L);
    int r[kS];
    float xv[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int l = li + i * U;
      r[i] = l < L ? crow[l] : 0;
      xv[i] = l < L ? cx[l] : 0.f;
    }
    bool keep[kS];
    float ev[kS], qv[kS][kF], tqv[kS][kF];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int l = li + i * U;
      keep[i] = l < L && pr.gathers(l, r[i], xv[i]);
      ev[i] = keep[i] ? e[r[i]] : 0.f;
      if (keep[i]) {
        const int64_t o = static_cast<int64_t>(r[i]) * kF;
        load_vec<kF, V>(q + o, qv[i]);
        load_vec<kF, V>(tq + o, tqv[i]);
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) qv[i][f] = tqv[i][f] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (!keep[i]) continue;
      const float xb = xv[i];
      const float eb = ev[i];
      sxe += xb * eb;
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const float h = qv[i][f] - xb * mu_c[f];
        const float h1 = tqv[i][f] - xb * xb * sig_c[f];
        vm[f] += xb * h * (eb + xb * mu_c[f] * h);
        vs[f] += xb * xb * (h * h + h1);
      }
    }
  }
  for (int o = U >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      vm[f] += __shfl_xor_sync(svbfm::kFullMask, vm[f], o);
      vs[f] += __shfl_xor_sync(svbfm::kFullMask, vs[f], o);
    }
    if (rider) sxe += __shfl_xor_sync(svbfm::kFullMask, sxe, o);
  }
  if (!live || li != 0) return;
  if (kWin) {  // win bit 0: the first window; bit 1: the last
    float* arow = acc + c * 2 * kF;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      if (!(win & 1)) {
        vm[f] = arow[f] + vm[f];
        vs[f] = arow[kF + f] + vs[f];
      }
      if (!(win & 2)) {
        arow[f] = vm[f];
        arow[kF + f] = vs[f];
      }
    }
    if (!(win & 2)) return;
  }
  int bad = 0;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    // vb.py:449-469, as col_stats_kernel
    const float sig_cand = 1.f / (svv[f] + alpha * vs[f]);
    bad += isfinite(sig_cand) ? 0 : 1;
    const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c[f];
    const float mu_cand = sig_new * alpha * vm[f];
    bad += isfinite(mu_cand) ? 0 : 1;
    const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c[f];
    mu_t[col * kF + f] = mu_new;
    sig_t[col * kF + f] = sig_new;
    prow[2 * kF + f] = mu_new - mu_c[f];
    prow[3 * kF + f] = sig_new - sig_c[f];
    prow[4 * kF + f] = mu_new * mu_new - mu_c[f] * mu_c[f];
  }
  if (bad) atomicAdd(&nans[0], bad);
  if (rider) {  // vb.py:471-487, as col_stats_kernel
    const float wsig_cand = 1.f / (wprior + alpha * sxx);
    const float wsig_new = isfinite(wsig_cand) ? wsig_cand : wsig_c;
    const float wmu_cand = wsig_new * alpha * (sxe + wmu_c * sxx);
    const int wbad =
        (isfinite(wsig_cand) ? 0 : 1) + (isfinite(wmu_cand) ? 0 : 1);
    const float wmu_new = isfinite(wmu_cand) ? wmu_cand : wmu_c;
    mu_w[col] = wmu_new;
    sig_w[col] = wsig_new;
    prow[5 * kF] = wmu_c - wmu_new;
    prow[5 * kF + 1] = wsig_new - wsig_c;
    if (wbad) atomicAdd(&nans[1], wbad);
  }
}

// K3's lanes a column in the lanes form (mirrored by kernels/vb_sweep.py:
// col_stats_lanes): the next power of two >= L / 4 (>= L / 2 in a bucket of
// fewer than 2,048 columns), 8 to 32.
int stat_lanes(int C, int L) {
  const int per = C < 2048 ? kStatLanesSlots / 2 : kStatLanesSlots;
  int U = 8;
  while (U < 32 && U * per < L) U <<= 1;
  return U;
}

template <bool kWin>
int launch_col_stats_lanes(int C, int L, int F, int V, const int* rows,
                           const float* x, const int* cols, const int* group,
                           const float* sx2, const float* e, const float* q,
                           const float* tq, float* ptab, int CH, float* mu_t,
                           float* sig_t, const float* sv, const float* alpha,
                           float* mu_w, float* sig_w, const float* sigma_w,
                           int* nans, float* acc, int win,
                           cudaStream_t stream) {
  const int U = stat_lanes(C, L);
  const int cpb = svbfm::lanes_block_cols(C, U, kStatLanesThreads);
  const int threads = cpb * U;
  const unsigned blocks = static_cast<unsigned>((C + cpb - 1) / cpb);
  auto go = [&](auto f, auto v) {
    constexpr int kF = decltype(f)::value;
    constexpr int kV = decltype(v)::value;
    col_stats_lanes_kernel<kF, kV, kWin><<<blocks, threads, 0, stream>>>(
        rows, x, C, L, U, cols, group, sx2, e, q, tq, ptab, CH, mu_t, sig_t,
        sv, alpha, mu_w, sig_w, sigma_w, nans, acc, win);
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  switch (F) {
    case 1:
      go(I1(), I1());
      break;
    case 2:
      V == 2 ? go(I2(), I2()) : go(I2(), I1());
      break;
    case 3:
      go(std::integral_constant<int, 3>(), I1());
      break;
    case 4:
      V == 4 ? go(I4(), I4()) : V == 2 ? go(I4(), I2()) : go(I4(), I1());
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V, bool kWin>
int launch_col_stats(int C, int L, int F, int G, const int* rows,
                     const float* x, const int* cols, const int* group,
                     const float* sx2, const float* e, const float* q,
                     const float* tq, float* ptab, int CH, float* mu_t,
                     float* sig_t, const float* sv, const float* alpha,
                     float* mu_w, float* sig_w, const float* sigma_w,
                     int* nans, float* acc, int win, cudaStream_t stream) {
  const int ny = ceil_div(G, kStatChunks);
  const int GT = ceil_div(G, ny);
  const int SW = 32 / GT;
  // enough warps for one round of entries, at most kStatWarps; at least a
  // thread for each value a slot sums (the tree)
  const int least = ceil_div(GT * 2 * V, 32);
  int warps = ceil_div(L, stat_batch<V>() * SW);
  warps = warps < least ? least : warps > kStatWarps ? kStatWarps : warps;
  const int threads = 32 * warps;
  const int T = L < kStatTile ? L : kStatTile;
  const size_t smem =
      sizeof(float) * (2 * T + warps * SW * GT * 2 * V + threads + 32);
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>(ny));
  col_stats_kernel<V, kWin><<<grid, threads, smem, stream>>>(
      rows, x, L, cols, group, sx2, e, q, tq, F, GT, ptab, CH, mu_t, sig_t,
      sv, alpha, mu_w, sig_w, sigma_w, nans, acc, win);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4: per-bin row-cache patch ------------------------------------------
// kSeq (batch VB): positions are walked in order p = 0..P-1 and q/tq/tz
// change between positions (vb.py:523-549).  !kSeq (online VB,
// vb_online.py:561-580): every position reads the caches from before the
// patch.  The two agree
// wherever a row has at most one entry in the bin (conflict-free bins).
// Template parameters and not runtime flags, so the batch-VB loop compiles
// as it would alone.  Each row owns its cache slots, so the in-place
// update has no races.
constexpr int kPatchThreads = 256;

// A thread a row: F = 1 (exact-mode VB, the online-VB chunks) and F = 0,
// the w patch, where lanes over factors would idle.  Only the w patch of
// MCMC has no t cache (t == nullptr); at F = 1 the wrapper always passes t.
template <bool kSeq>
__global__ void patch_rows_kernel(const float* __restrict__ ptab, int CH,
                                  int F, int merge_w,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ vals, int64_t N,
                                  int P, float* __restrict__ q,
                                  float* __restrict__ tq,
                                  float* __restrict__ tz,
                                  float* __restrict__ e,
                                  float* __restrict__ t) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kPatchThreads +
                    threadIdx.x;
  if (n >= N) return;
  const bool has_t = t != nullptr;
  float ev = e[n];
  float tv = has_t ? t[n] : 0.f;
  for (int p = 0; p < P; ++p) {
    const float* g = ptab + static_cast<int64_t>(ids[n * P + p]) * CH;
    const float xv = vals[n * P + p];
    const float x2 = xv * xv;
    float esum = 0.f, tsum = 0.f;
    for (int f = 0; f < F; ++f) {
      const float mu_e = g[f];
      const float sig_e = g[F + f];
      const float dmu = g[2 * F + f];
      const float dsig = g[3 * F + f];
      const float dmu2 = g[4 * F + f];
      const int64_t o = n * F + f;
      const float qv = q[o], tqv = tq[o], tzv = tz[o];
      const float he = xv * (qv - xv * mu_e);
      const float h1e = x2 * (tqv - x2 * sig_e);
      const float h2e = x2 * (tzv - x2 * mu_e * mu_e);
      if (kSeq) {
        q[o] = qv + xv * dmu;
        tq[o] = tqv + x2 * dsig;
        tz[o] = tzv + x2 * dmu2;
      }
      esum += he * dmu;
      tsum += (h1e + h2e) * dsig + h1e * dmu2;
    }
    ev = ev - esum;
    tv = tv + tsum;
    if (merge_w) {
      ev = ev + xv * g[5 * F];
      tv = tv + xv * xv * g[5 * F + 1];
    }
  }
  if (!kSeq) {
    for (int f = 0; f < F; ++f) {
      const int64_t o = n * F + f;
      float dq = 0.f, dtq = 0.f, dtz = 0.f;
      for (int p = 0; p < P; ++p) {
        const float* g = ptab + static_cast<int64_t>(ids[n * P + p]) * CH;
        const float xv = vals[n * P + p];
        const float x2 = xv * xv;
        dq += xv * g[2 * F + f];
        dtq += x2 * g[3 * F + f];
        dtz += x2 * g[4 * F + f];
      }
      q[o] += dq;
      tq[o] += dtq;
      tz[o] += dtz;
    }
  }
  e[n] = ev;
  if (has_t) t[n] = tv;
}

// F >= 2: TPR threads a row, thread j of a row owning the V-factor chunks
// j, j + TPR, ... (at F = 20: 5 threads of 4 factors, 51 rows a block, 255
// of 256 threads busy).  Consecutive threads hold consecutive chunks of
// consecutive rows, so the cache reads and writes are 16-byte loads that
// cover a contiguous run of the [N, F] cache; the ptab row of each position
// is gathered in W-float pieces (W = 4 where CH % 4 == 0, else 2: with the
// w rider CH = 5F + 2), the next position's piece loaded before this one's
// arithmetic.  A chunk's caches stay in registers across the positions (so
// kSeq's order costs nothing); the chunk sums of e and t meet in shared
// memory and the row's first thread adds them in chunk order.
template <bool kSeq, int V, int W>
__global__ void __launch_bounds__(kPatchThreads)
patch_rows_wide_kernel(const float* __restrict__ ptab, int CH, int F,
                       int merge_w, const int* __restrict__ ids,
                       const float* __restrict__ vals, int64_t N, int P,
                       int TPR, float* __restrict__ q, float* __restrict__ tq,
                       float* __restrict__ tz, float* __restrict__ e,
                       float* __restrict__ t) {
  __shared__ float s_es[kPatchThreads];
  __shared__ float s_ts[kPatchThreads];
  const int G = F / V;
  const int rr = threadIdx.x / TPR;
  const int j = threadIdx.x - rr * TPR;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * (blockDim.x / TPR) + rr;
  const bool valid = n < N;
  float es = 0.f, ts = 0.f;
  if (valid) {
    const int* nid = ids + n * P;
    const float* nx = vals + n * P;
    for (int ch = j; ch < G; ch += TPR) {
      const int f0 = ch * V;
      const int64_t o = n * F + f0;
      float qv[V], tqv[V], tzv[V], q0[V], tq0[V], tz0[V];
      load_vec<V, V>(q + o, qv);
      load_vec<V, V>(tq + o, tqv);
      load_vec<V, V>(tz + o, tzv);
      if (!kSeq) {
#pragma unroll
        for (int k = 0; k < V; ++k) q0[k] = qv[k], tq0[k] = tqv[k], tz0[k] = tzv[k];
      }
      // g[c] = channel c (mu_old, sig_old, dmu, dsig, dmu2) of this chunk
      float g[5][V], gn[5][V];
      float xv = nx[0];
      {
        const float* row = ptab + static_cast<int64_t>(nid[0]) * CH + f0;
#pragma unroll
        for (int c = 0; c < 5; ++c) load_vec<V, W>(row + c * F, g[c]);
      }
      for (int p = 0; p < P; ++p) {
        const bool more = p + 1 < P;
        float xn = 0.f;
        if (more) {
          xn = nx[p + 1];
          const float* row = ptab + static_cast<int64_t>(nid[p + 1]) * CH + f0;
#pragma unroll
          for (int c = 0; c < 5; ++c) load_vec<V, W>(row + c * F, gn[c]);
        }
        const float x2 = xv * xv;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float qc = kSeq ? qv[k] : q0[k];
          const float tqc = kSeq ? tqv[k] : tq0[k];
          const float tzc = kSeq ? tzv[k] : tz0[k];
          const float mu_e = g[0][k];
          const float he = xv * (qc - xv * mu_e);
          const float h1e = x2 * (tqc - x2 * g[1][k]);
          const float h2e = x2 * (tzc - x2 * mu_e * mu_e);
          qv[k] += xv * g[2][k];
          tqv[k] += x2 * g[3][k];
          tzv[k] += x2 * g[4][k];
          es += he * g[2][k];
          ts += (h1e + h2e) * g[3][k] + h1e * g[4][k];
        }
        if (more) {
          xv = xn;
#pragma unroll
          for (int c = 0; c < 5; ++c)
#pragma unroll
            for (int k = 0; k < V; ++k) g[c][k] = gn[c][k];
        }
      }
      store_vec<V>(q + o, qv);
      store_vec<V>(tq + o, tqv);
      store_vec<V>(tz + o, tzv);
    }
  }
  s_es[threadIdx.x] = es;
  s_ts[threadIdx.x] = ts;
  __syncthreads();
  if (valid && j == 0) {
    float esum = 0.f, tsum = 0.f;
    for (int k = 0; k < TPR; ++k) {
      esum += s_es[rr * TPR + k];
      tsum += s_ts[rr * TPR + k];
    }
    float ev = e[n] - esum;
    float tv = t[n] + tsum;
    if (merge_w) {
      for (int p = 0; p < P; ++p) {
        const float* g = ptab + static_cast<int64_t>(ids[n * P + p]) * CH;
        const float xv = vals[n * P + p];
        ev = ev + xv * g[5 * F];
        tv = tv + xv * xv * g[5 * F + 1];
      }
    }
    e[n] = ev;
    t[n] = tv;
  }
}

template <bool kSeq, int V, int W>
void launch_patch_wide(unsigned blocks, int threads, int TPR,
                       const float* ptab, int CH, int F, int merge_w,
                       const int* ids, const float* vals, int64_t N, int P,
                       float* q, float* tq, float* tz, float* e, float* t,
                       cudaStream_t stream) {
  patch_rows_wide_kernel<kSeq, V, W><<<blocks, threads, 0, stream>>>(
      ptab, CH, F, merge_w, ids, vals, N, P, TPR, q, tq, tz, e, t);
}

template <bool kSeq>
void patch_wide(const float* ptab, int CH, int F, int merge_w,
                const int* ids, const float* vals, int64_t N, int P,
                float* q, float* tq, float* tz, float* e, float* t,
                cudaStream_t stream) {
  int V = chunk_width(F, q, tq, tz);
  int W = V;
  while (W > 1 && (CH % W != 0 || !aligned(ptab, 4u * W))) W /= 2;
  if (W == 1) V = 1;  // chunks of 4 or 2 read in single floats: not built
  const int G = F / V;
  const int TPR = ceil_div(G, ceil_div(G, 32));
  const int rows = kPatchThreads / TPR;
  const unsigned blocks = static_cast<unsigned>((N + rows - 1) / rows);
  const int threads = rows * TPR;
  auto go = V == 4 ? (W == 4 ? &launch_patch_wide<kSeq, 4, 4>
                             : &launch_patch_wide<kSeq, 4, 2>)
          : V == 2 ? &launch_patch_wide<kSeq, 2, 2>
                   : &launch_patch_wide<kSeq, 1, 1>;
  go(blocks, threads, TPR, ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz,
     e, t, stream);
}

// ---- T1-T4's sweep kernels: the feature-sharded sweep ----------------------
// Replaces the XLA chains of svbfm_tpu/parallel/tp_vb.py:tp_vb_update_all
// (fast mode, all K factors in one block, the w rider on): each rank holds
// the columns [lo, lo + D_loc) of the tables (its feature shard) and the
// rows of its data shard, and a sum that crosses a shard is taken by an
// all-reduce between two launches.  Local column ids run 0 .. D_loc - 1;
// a bucket's padding columns carry the local id D_loc and are skipped
// (JAX drops them through an out-of-bounds .at[].set; here such a write
// would land outside the table).  The row caches are one [N, 3F] buffer
// qt = (q | tq | tz), so that one feature all-reduce serves the three.
// Simple forms: each of these kernels is right first.
//
// T2 (tp_vb.py:337-353): qt of the shard's ids, K2's sums.  A thread a
// (row, chunk of V factors); an id outside [lo, lo + D_loc) adds nothing
// and reads no ptab row.
// T6 (kQOnly, svbfm_tpu/parallel/tp_mcmc.py:230-238): the feature-sharded
// Gibbs/ALS block's q [N, F] alone, from ptab's channels 0..F-1 (v).
template <int V, bool kQOnly = false>
__global__ void __launch_bounds__(kQtThreads)
    tp_build_qt_kernel(const float* __restrict__ ptab, int64_t ld, int F,
                       int64_t lo, int D_loc, const int* __restrict__ ids,
                       const float* __restrict__ vals, int64_t N, int P,
                       float* __restrict__ qt) {
  const int C = F / V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= N * C) return;
  const int64_t n = i / C;
  const int ch = static_cast<int>(i - n * C);
  float qa[V], tqa[V], tza[V];
#pragma unroll
  for (int k = 0; k < V; ++k) qa[k] = tqa[k] = tza[k] = 0.f;
  for (int p = 0; p < P; ++p) {
    const int64_t loc = static_cast<int64_t>(ids[n * P + p]) - lo;
    if (loc < 0 || loc >= D_loc) continue;
    const float x = vals[n * P + p];
    const float x2 = x * x;
    const float* row = ptab + loc * ld + ch * V;
    float mu[V], sg[V];
    load_vec<V>(row, mu);
    if constexpr (!kQOnly) load_vec<V>(row + F, sg);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      qa[k] += mu[k] * x;
      if constexpr (!kQOnly) {
        tqa[k] += sg[k] * x2;
        tza[k] += mu[k] * mu[k] * x2;
      }
    }
  }
  if constexpr (kQOnly) {
    store_vec<V>(qt + n * F + ch * V, qa);
  } else {
    float* o = qt + n * 3 * F + ch * V;
    store_vec<V>(o, qa);
    store_vec<V>(o + F, tqa);
    store_vec<V>(o + 2 * F, tza);
  }
}

// T3's stats launch (tp_vb.py:355-382, 396; K3's sums with the w rider's
// sum x e): one block a column of a [C, L] bucket, TF = min(F, 32) threads
// a slot over the column's factors (factor groups of TF in turn) and
// 128 / TF slots over its entries; acc [C, 2F + 1] = (vm | vs | sxe) of the
// rows of this data shard, summed over the slots in a fixed order (shared
// memory, no atomics).  Every slot is added, as the twin adds it: a
// padding entry has x = 0.  A padding column gets a zero row.
constexpr int kTpStatThreads = 128;

__global__ void __launch_bounds__(kTpStatThreads)
    tp_col_stats_kernel(const int* __restrict__ rows,
                        const float* __restrict__ x, int L,
                        const int* __restrict__ cols, int D_loc,
                        const float* __restrict__ e,
                        const float* __restrict__ qt, int F,
                        const float* __restrict__ ptab, int CH,
                        float* __restrict__ acc) {
  __shared__ float s_vm[kTpStatThreads], s_vs[kTpStatThreads];
  __shared__ float s_xe[kTpStatThreads];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int TF = F < 32 ? F : 32;
  const int S = kTpStatThreads / TF;  // slots
  const int sl = tid / TF;
  const int j = tid - sl * TF;
  const bool on = sl < S;
  const int64_t col = cols[c];
  float* arow = acc + static_cast<int64_t>(c) * (2 * F + 1);
  if (col == D_loc) {  // a padding column
    for (int u = tid; u < 2 * F + 1; u += blockDim.x) arow[u] = 0.f;
    return;
  }
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  const float* prow = ptab + col * CH;
  for (int f0 = 0; f0 < F; f0 += TF) {
    const int f = f0 + j;
    const bool act = on && f < F;
    const float mu_c = act ? prow[f] : 0.f;
    const float sig_c = act ? prow[F + f] : 0.f;
    float vm = 0.f, vs = 0.f, xe = 0.f;
    for (int l = sl; on && l < L; l += S) {
      const int64_t r = crow[l];
      const float xb = cx[l];
      const float eb = e[r];
      if (f0 == 0 && j == 0) xe += xb * eb;
      if (act) {
        const float h = qt[r * 3 * F + f] - xb * mu_c;
        const float h1 = qt[r * 3 * F + F + f] - xb * xb * sig_c;
        vm += xb * h * (eb + xb * mu_c * h);
        vs += xb * xb * (h * h + h1);
      }
    }
    s_vm[tid] = vm;
    s_vs[tid] = vs;
    s_xe[tid] = xe;
    __syncthreads();
    if (tid < TF && f0 + tid < F) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < S; ++k) {
        a += s_vm[k * TF + tid];
        b += s_vs[k * TF + tid];
      }
      arow[f0 + tid] = a;
      arow[F + f0 + tid] = b;
    }
    if (f0 == 0 && tid == 0) {
      float a = 0.f;
      for (int k = 0; k < S; ++k) a += s_xe[k * TF];
      arow[2 * F] = a;
    }
    __syncthreads();  // the next factor group reuses the staging
  }
}

// T3's update launch (tp_vb.py:383-405): K3's closed form from the
// column sums acc [C, 2F + 1], summed over the data shards, and no rows; a
// thread a (column, factor), and at factor F the w rider.  Writes
// mu_t/sig_t [D_loc, F] and mu_w/sig_w at the column, ptab's delta
// channels (dmu, dsig, dmu2 [, wdmu, wdsig]) and the counts of candidates
// that were not finite into nans[0] (v) and nans[1] (w); mu_w == nullptr
// turns the w rider off.  Padding columns are skipped.
__global__ void __launch_bounds__(256)
    tp_col_update_kernel(const float* __restrict__ acc, int C,
                         const int* __restrict__ cols, int D_loc,
                         const int* __restrict__ group,
                         const float* __restrict__ sx2, int F,
                         float* __restrict__ ptab, int CH,
                         float* __restrict__ mu_t, float* __restrict__ sig_t,
                         const float* __restrict__ sv,
                         const float* __restrict__ alpha_p,
                         float* __restrict__ mu_w, float* __restrict__ sig_w,
                         const float* __restrict__ sigma_w,
                         int* __restrict__ nans) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t c = i / (F + 1);
  const int f = static_cast<int>(i - c * (F + 1));
  if (c >= C) return;
  const int64_t col = cols[c];
  if (col == D_loc) return;  // a padding column
  const int g = group[c];
  const float alpha = *alpha_p;
  const float* arow = acc + c * (2 * F + 1);
  float* prow = ptab + col * CH;
  if (f < F) {  // vb.py:449-469, as K3
    const float mu_c = prow[f], sig_c = prow[F + f];
    const float sig_cand = 1.f / (sv[g * F + f] + alpha * arow[F + f]);
    const float sig_new = isfinite(sig_cand) ? sig_cand : sig_c;
    const float mu_cand = sig_new * alpha * arow[f];
    const float mu_new = isfinite(mu_cand) ? mu_cand : mu_c;
    const int bad = (isfinite(sig_cand) ? 0 : 1) + (isfinite(mu_cand) ? 0 : 1);
    mu_t[col * F + f] = mu_new;
    sig_t[col * F + f] = sig_new;
    prow[2 * F + f] = mu_new - mu_c;
    prow[3 * F + f] = sig_new - sig_c;
    prow[4 * F + f] = mu_new * mu_new - mu_c * mu_c;
    if (bad) atomicAdd(&nans[0], bad);
  } else if (mu_w != nullptr) {  // vb.py:471-487, as K3's rider
    const float wmu_c = mu_w[col], wsig_c = sig_w[col], sxx = sx2[c];
    const float wsig_cand = 1.f / (sigma_w[g] + alpha * sxx);
    const float wsig_new = isfinite(wsig_cand) ? wsig_cand : wsig_c;
    const float wmu_cand = wsig_new * alpha * (arow[2 * F] + wmu_c * sxx);
    const int wbad =
        (isfinite(wsig_cand) ? 0 : 1) + (isfinite(wmu_cand) ? 0 : 1);
    const float wmu_new = isfinite(wmu_cand) ? wmu_cand : wmu_c;
    mu_w[col] = wmu_new;
    sig_w[col] = wsig_new;
    prow[5 * F] = wmu_c - wmu_new;
    prow[5 * F + 1] = wsig_new - wsig_c;
    if (wbad) atomicAdd(&nans[1], wbad);
  }
}

// T4 (tp_vb.py:407-453; at F = 0 the w patch, :483-496): K4 in its delta
// mode.  The contributions of a row's ids in the window [lo, lo + D_loc),
// against the PRE-patch caches qt, written to out and not applied: at
// several feature shards each shard's part must see the caches from
// before the bin, and the parts are summed by a feature all-reduce before
// the add.  out is one buffer of N (3F + 2) floats, planar where that
// keeps the add after the all-reduce contiguous: the [N, 3F] deltas
// (dq | dtq | dtz) of the rows, then de [N], then dt [N].  ptab [D_loc,
// CH], CH = 5F (+2 with the w rider, merge_w); at F = 0 it is the w delta
// table [D_loc, 2].  K4's wide form (patch_rows_wide_kernel): TPR threads
// a row, thread j owning the V-factor chunks j, j + TPR, ..., the caches
// read and the deltas written as V-float vectors, the ptab pieces in
// W-float loads; a row's e and t sums meet in shared memory, added in
// chunk order by the row's first thread, which adds the w rider's.
template <int V, int W>
__global__ void __launch_bounds__(kPatchThreads)
    tp_patch_delta_kernel(const float* __restrict__ ptab, int CH, int F,
                          int merge_w, int64_t lo, int D_loc,
                          const int* __restrict__ ids,
                          const float* __restrict__ vals, int64_t N, int P,
                          int TPR, const float* __restrict__ qt,
                          float* __restrict__ out) {
  __shared__ float s_es[kPatchThreads];
  __shared__ float s_ts[kPatchThreads];
  const int G = F / V;
  const int rr = threadIdx.x / TPR;
  const int j = threadIdx.x - rr * TPR;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / TPR) + rr;
  const bool valid = n < N;
  const int* nid = ids + n * P;
  const float* nx = vals + n * P;
  float es = 0.f, ts = 0.f;
  if (valid) {
    for (int ch = j; ch < G; ch += TPR) {
      const int f0 = ch * V;
      const float* qrow = qt + n * 3 * F + f0;
      float qv[V], tqv[V], tzv[V], dq[V], dtq[V], dtz[V];
      load_vec<V, V>(qrow, qv);
      load_vec<V, V>(qrow + F, tqv);
      load_vec<V, V>(qrow + 2 * F, tzv);
#pragma unroll
      for (int k = 0; k < V; ++k) dq[k] = dtq[k] = dtz[k] = 0.f;
      for (int p = 0; p < P; ++p) {
        const int64_t loc = static_cast<int64_t>(nid[p]) - lo;
        if (loc < 0 || loc >= D_loc) continue;  // another shard's id
        const float* row = ptab + loc * CH + f0;
        float g[5][V];
#pragma unroll
        for (int c = 0; c < 5; ++c) load_vec<V, W>(row + c * F, g[c]);
        const float xv = nx[p];
        const float x2 = xv * xv;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float mu_e = g[0][k];
          const float he = xv * (qv[k] - xv * mu_e);
          const float h1e = x2 * (tqv[k] - x2 * g[1][k]);
          const float h2e = x2 * (tzv[k] - x2 * mu_e * mu_e);
          dq[k] += xv * g[2][k];
          dtq[k] += x2 * g[3][k];
          dtz[k] += x2 * g[4][k];
          es += he * g[2][k];
          ts += (h1e + h2e) * g[3][k] + h1e * g[4][k];
        }
      }
      float* orow = out + n * 3 * F + f0;
      store_vec<V>(orow, dq);
      store_vec<V>(orow + F, dtq);
      store_vec<V>(orow + 2 * F, dtz);
    }
  }
  s_es[threadIdx.x] = es;
  s_ts[threadIdx.x] = ts;
  __syncthreads();
  if (valid && j == 0) {
    float esum = 0.f, tsum = 0.f;
    for (int k = 0; k < TPR; ++k) {
      esum += s_es[rr * TPR + k];
      tsum += s_ts[rr * TPR + k];
    }
    float de = -esum, dt = tsum;
    if (merge_w) {
      for (int p = 0; p < P; ++p) {
        const int64_t loc = static_cast<int64_t>(nid[p]) - lo;
        if (loc < 0 || loc >= D_loc) continue;
        const float* g = ptab + loc * CH;
        const float xv = nx[p];
        de += xv * g[5 * F];
        dt += xv * xv * g[5 * F + 1];
      }
    }
    out[3 * F * N + n] = de;
    out[3 * F * N + N + n] = dt;
  }
}

}  // namespace

// ptab [D, ld] with mu in channels 0..F-1 and sigma in F..2F-1;
// q/tq/tz [N, F] out
SVBFM_EXPORT int svbfm_vb_build_qt(const float* ptab, int64_t ld, int F,
                                   const int* ids, const float* vals,
                                   int64_t N, int P, float* q, float* tq,
                                   float* tz, cudaStream_t stream) {
  return launch_qt<false>(ptab, ld, F, ids, vals, N, P, nullptr, q, tq, tz,
                          stream);
}

// X8d: q [N, F] = q0 + sum_p ptab[id, f] x over channels 0..F-1 of ptab
// [D, ld]; q0 [N, F] may be nullptr (0)
SVBFM_EXPORT int svbfm_build_q(const float* ptab, int64_t ld, int F,
                               const int* ids, const float* vals, int64_t N,
                               int P, const float* q0, float* q,
                               cudaStream_t stream) {
  return launch_qt<true>(ptab, ld, F, ids, vals, N, P, q0, q, nullptr,
                         nullptr, stream);
}

// One [C, L] bucket.  Writes mu_t/sig_t [D, F] and mu_w/sig_w [D] in place
// at the bucket's columns, and ptab's delta channels; nans[0] += v
// candidates that were not finite, nans[1] += w ones.  mu_w == nullptr
// turns the w rider off (then sx2, sig_w and sigma_w are not read).  The
// form (mirrored by kernels/vb_sweep.py:col_stats_form): the lanes form at
// F <= 4 on buckets of L <= 128, else a block a column (and group of
// chunks).
SVBFM_EXPORT int svbfm_vb_col_stats_update(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* sx2, const float* e, const float* q,
    const float* tq, int F, float* ptab, int CH, float* mu_t, float* sig_t,
    const float* sv, const float* alpha, float* mu_w, float* sig_w,
    const float* sigma_w, int* nans, cudaStream_t stream) {
  const int V = chunk_width(F, q, tq);
  if (F <= kStatLanesMaxF && L <= kStatLanesMaxL)
    return launch_col_stats_lanes<false>(
        C, L, F, V, rows, x, cols, group, sx2, e, q, tq, ptab, CH, mu_t,
        sig_t, sv, alpha, mu_w, sig_w, sigma_w, nans, nullptr, 0, stream);
  auto go = V == 4 ? &launch_col_stats<4, false>
          : V == 2 ? &launch_col_stats<2, false>
                   : &launch_col_stats<1, false>;
  return go(C, L, F, F / V, rows, x, cols, group, sx2, e, q, tq, ptab, CH,
            mu_t, sig_t, sv, alpha, mu_w, sig_w, sigma_w, nans, nullptr, 0,
            stream);
}

// X13a: one window's [C, L] view of a bucket, its rows local to the
// window's caches e [Wlen], q/tq [Wlen, F]; the window sums go into acc
// [C, 2F] (vm | vs) in window order, win bit 0 marking the first window
// and bit 1 the last, whose launch also applies the update from acc and
// writes mu_t/sig_t and ptab's delta channels (CH = 5F) as the resident
// mode does, in its form; nans[0] += the v candidates that were not
// finite.
SVBFM_EXPORT int svbfm_vb_col_stats_window(
    const int* rows, const float* x, int C, int L, const int* cols,
    const int* group, const float* e, const float* q, const float* tq, int F,
    float* ptab, float* mu_t, float* sig_t, const float* sv,
    const float* alpha, int* nans, float* acc, int win, cudaStream_t stream) {
  const int V = chunk_width(F, q, tq);
  if (F <= kStatLanesMaxF && L <= kStatLanesMaxL)
    return launch_col_stats_lanes<true>(
        C, L, F, V, rows, x, cols, group, nullptr, e, q, tq, ptab, 5 * F,
        mu_t, sig_t, sv, alpha, nullptr, nullptr, nullptr, nans, acc, win,
        stream);
  auto go = V == 4 ? &launch_col_stats<4, true>
          : V == 2 ? &launch_col_stats<2, true>
                   : &launch_col_stats<1, true>;
  return go(C, L, F, F / V, rows, x, cols, group, nullptr, e, q, tq, ptab,
            5 * F, mu_t, sig_t, sv, alpha, nullptr, nullptr, nullptr, nans,
            acc, win, stream);
}

// Patch q/tq/tz [N, F] and e/t [N] in place from ptab [D, CH]; seq
// selects the batch-VB (1) or online-VB (0) position order; a thread per
// row at F = 1, chunks of a row over threads at F >= 2.  The w patch
// (F = 0) has its own launch below, a thread per row.
SVBFM_EXPORT int svbfm_vb_patch_rows(const float* ptab, int CH, int F,
                                     int merge_w, int seq, const int* ids,
                                     const float* vals, int64_t N, int P,
                                     float* q, float* tq, float* tz, float* e,
                                     float* t, cudaStream_t stream) {
  if (F == 1) {
    const unsigned blocks =
        static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
    if (seq) {
      patch_rows_kernel<true><<<blocks, kPatchThreads, 0, stream>>>(
          ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
    } else {
      patch_rows_kernel<false><<<blocks, kPatchThreads, 0, stream>>>(
          ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (seq) {
    patch_wide<true>(ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t,
                     stream);
  } else {
    patch_wide<false>(ptab, CH, F, merge_w, ids, vals, N, P, q, tq, tz, e, t,
                      stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The w patch of the standalone linear-term sweep: K4 at F = 0, one thread
// per row, its table dtab [D, 2] being the two w channels (mu_old - mu_new,
// sig_new - sig_old); e/t [N] += sum_p x dtab[id, 0], sum_p x^2 dtab[id, 1].
// MCMC's w sweep passes t == nullptr and dtab[:, 0] = w_new - w_old (its
// e = yhat - y has the opposite sign of VB's).
SVBFM_EXPORT int svbfm_w_patch_rows(const float* dtab, const int* ids,
                                    const float* vals, int64_t N, int P,
                                    float* e, float* t, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((N + kPatchThreads - 1) / kPatchThreads);
  patch_rows_kernel<true><<<blocks, kPatchThreads, 0, stream>>>(
      dtab, 2, 0, 1, ids, vals, N, P, nullptr, nullptr, nullptr, e, t);
  return static_cast<int>(cudaGetLastError());
}

// T2: qt [N, 3F] = (q | tq | tz) of rows ids/vals [N, P] over the ids of
// one feature shard [lo, lo + D_loc), from ptab [D_loc, ld] (mu in channels
// 0..F-1, sigma in F..2F-1).  Chunks of 4, 2 or 1 factors: the widest that
// divides F and ld and to whose size ptab and qt are aligned.
SVBFM_EXPORT int svbfm_tp_build_qt(const float* ptab, int64_t ld, int F,
                                   int64_t lo, int D_loc, const int* ids,
                                   const float* vals, int64_t N, int P,
                                   float* qt, cudaStream_t stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaSuccess);
  int V = chunk_width(F, ptab, qt);
  while (V > 1 && ld % V != 0) V /= 2;
  const int64_t threads = N * (F / V);
  const unsigned blocks =
      static_cast<unsigned>((threads + kQtThreads - 1) / kQtThreads);
  auto kernel = V == 4   ? tp_build_qt_kernel<4>
                : V == 2 ? tp_build_qt_kernel<2>
                         : tp_build_qt_kernel<1>;
  kernel<<<blocks, kQtThreads, 0, stream>>>(ptab, ld, F, lo, D_loc, ids,
                                            vals, N, P, qt);
  return static_cast<int>(cudaGetLastError());
}

// T6: q [N, F] of rows ids/vals [N, P] over the ids of one feature shard
// [lo, lo + D_loc), from ptab [D_loc, ld]'s channels 0..F-1; chunks as T2's.
SVBFM_EXPORT int svbfm_tp_build_q(const float* ptab, int64_t ld, int F,
                                  int64_t lo, int D_loc, const int* ids,
                                  const float* vals, int64_t N, int P,
                                  float* q, cudaStream_t stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaSuccess);
  int V = chunk_width(F, ptab, q);
  while (V > 1 && ld % V != 0) V /= 2;
  const int64_t threads = N * (F / V);
  const unsigned blocks =
      static_cast<unsigned>((threads + kQtThreads - 1) / kQtThreads);
  auto kernel = V == 4   ? tp_build_qt_kernel<4, true>
                : V == 2 ? tp_build_qt_kernel<2, true>
                         : tp_build_qt_kernel<1, true>;
  kernel<<<blocks, kQtThreads, 0, stream>>>(ptab, ld, F, lo, D_loc, ids,
                                            vals, N, P, q);
  return static_cast<int>(cudaGetLastError());
}

// T3, stats: acc [C, 2F + 1] = (vm | vs | sum x e) of one [C, L] bucket's
// columns (local ids cols [C], padding D_loc) over this data shard's rows
// (rows local to e [N] and qt [N, 3F]), from ptab's pre-bin mu/sig.
SVBFM_EXPORT int svbfm_tp_col_stats(const int* rows, const float* x, int C,
                                    int L, const int* cols, int D_loc,
                                    const float* e, const float* qt, int F,
                                    const float* ptab, int CH, float* acc,
                                    cudaStream_t stream) {
  if (C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  tp_col_stats_kernel<<<static_cast<unsigned>(C), kTpStatThreads, 0,
                        stream>>>(rows, x, L, cols, D_loc, e, qt, F, ptab, CH,
                                  acc);
  return static_cast<int>(cudaGetLastError());
}

// T3, update: the closed form at the bucket's columns from acc [C, 2F + 1]
// (see tp_col_update_kernel); mu_w == nullptr: no w rider.
SVBFM_EXPORT int svbfm_tp_col_update(
    const float* acc, int C, const int* cols, int D_loc, const int* group,
    const float* sx2, int F, float* ptab, int CH, float* mu_t, float* sig_t,
    const float* sv, const float* alpha, float* mu_w, float* sig_w,
    const float* sigma_w, int* nans, cudaStream_t stream) {
  if (C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  const int64_t threads = static_cast<int64_t>(C) * (F + 1);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  tp_col_update_kernel<<<blocks, 256, 0, stream>>>(
      acc, C, cols, D_loc, group, sx2, F, ptab, CH, mu_t, sig_t, sv, alpha,
      mu_w, sig_w, sigma_w, nans);
  return static_cast<int>(cudaGetLastError());
}

// T4: out [N (3F + 2)] = the [N, 3F] (dq | dtq | dtz), then de [N], then
// dt [N]: the bin's patch of the rows ids/vals [N, P] from the ids of one
// feature shard, against the pre-patch caches qt [N, 3F] (unread at
// F = 0); ptab [D_loc, CH].  Chunks of V = 4, 2 or 1 factors (the widest
// that divides F and to whose size qt and out are aligned), ptab's pieces
// in loads of W floats (W <= V, dividing CH, ptab aligned to it).
SVBFM_EXPORT int svbfm_tp_patch_delta(const float* ptab, int CH, int F,
                                      int merge_w, int64_t lo, int D_loc,
                                      const int* ids, const float* vals,
                                      int64_t N, int P, const float* qt,
                                      float* out, cudaStream_t stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  int V = F > 0 ? chunk_width(F, qt, out) : 1;
  int W = V;
  while (W > 1 && (CH % W != 0 || !aligned(ptab, 4u * W))) W /= 2;
  if (W == 1) V = 1;
  const int G = F / V;
  const int TPR = G > 0 ? ceil_div(G, ceil_div(G, 32)) : 1;
  const int rows = kPatchThreads / TPR;
  const unsigned blocks = static_cast<unsigned>((N + rows - 1) / rows);
  auto kernel = V == 4   ? (W == 4 ? tp_patch_delta_kernel<4, 4>
                                   : tp_patch_delta_kernel<4, 2>)
                : V == 2 ? tp_patch_delta_kernel<2, 2>
                         : tp_patch_delta_kernel<1, 1>;
  kernel<<<blocks, rows * TPR, 0, stream>>>(ptab, CH, F, merge_w, lo, D_loc,
                                            ids, vals, N, P, TPR, qt, out);
  return static_cast<int>(cudaGetLastError());
}
