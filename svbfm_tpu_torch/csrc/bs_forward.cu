// X10d: the block-structure (BS) relation-row moments and the data-row
// resync of the native relational Gibbs/ALS sampler.  (X10d's joined
// scores, bs_scores, are K1a's kernel in its relations mode:
// fm_forward.cu.)
//
// Replaces the XLA gather chains of svbfm_tpu/learners/mcmc_bs.py:
//   bs_rel_moments: the relation-row moments of bs_scores (:230-234,
//     :251-258) and the qB of every factor at the v sweep's entry
//     (:700-708): per relation row rho, over its row-layout positions,
//       qB_f = sum v_f x,  lin = sum w x,  sumsB = sum_f sum (v_f x)^2;
//     the scores use sB only through its sum over f, since
//     1/2 sum_f (s_f^2 - s2_f) = 1/2 (sum_f s_f^2 - sum_f s2_f);
//   bs_resync: the data-row resync after a relation sweep (:463-468,
//     :820-824, :689-690), with j = join[n] and qO = q - qB0[j],
//       e += sum_f dy_f[j] + sum_f qO_f (qB1_f[j] - qB0_f[j]),
//       q += qB1[j] - qB0[j];
//     and, with no qB0, dy or e, the q build q += qB1[j] (:490-497).
//
// Layouts: the parameter table stab [D_all, 1+K] = (w | v^T) of K1; a
// relation's row layout rids/rvals [R, Pr] in its local attribute ids,
// which sit at rows off .. off + Dr - 1 of stab; moments rows
// (qB | lin | sumsB), K + 2 channels at a row stride ldm that the wrapper
// makes a multiple of 8 floats (24 at K = 20: 96 bytes, three 32-byte
// sectors, for the scores' gathers), the padding never written or read;
// q [N, F] row-major; dy, qB0 [R, F]; qB1 rows of stride ld1 (the qB
// channels of X10b's relation table, or of the moments).
//
// Bound: bytes.  bs_rel_moments reads each relation row's ids and values
// and writes its K + 2 moments (20 MB for the users of the BS recipe at
// K = 20); the stab rows it gathers (a row's own one-hot attribute, then a
// few shared attribute rows) sit in L2 or L1.  What holds it is what a row
// costs in instructions and latency: lanes take the channels of (w | v),
// lin among them, three a lane, so that several rows share a warp and
// each shuffle that hands a position's id or x to the lanes serves them
// all; a row's ids come in coalesced loads, a batch of gathers is issued
// before its sums, and sumsB is one segmented shuffle over the row's
// lanes.  bs_resync reads each data row's join and q (and e) and gathers
// the joined dy, qB1 and qB0 rows from tables that L2 holds: its byte
// bound is q's read and write (160 MB at 1M rows, F = 20), but the
// gathers' L2 sectors (three a table a row at F = 20, one at F = 1, at
// random rows) take as long on the H100 (the q build, one table, runs near
// the byte bound; the full resync, three, does not).  Its lanes go over
// 16-byte chunks of a row where F, ld1 and the bases allow, 8- or 4-byte
// ones where not, several rows a warp (resync_chunks_kernel), or at F = 1
// over four rows a thread with 16-byte loads of join, q and e
// (resync_rows_kernel).
#include <type_traits>

#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // the moments' blocks
constexpr int kResyncThreads = 256;
constexpr int kResyncRows = 4;  // data rows a thread at F = 1
constexpr int kMomBatch = 8;    // positions a moments lane gathers at once
constexpr int kMomCh = 3;       // channels a moments lane takes a pass

using svbfm::aligned;
using svbfm::load_vec;
using svbfm::store_vec;

// The moments' lanes a relation row at K factors (mirrored by
// kernels/bs_forward.py:moments_plan): the next power of two >= (K + 1) /
// kMomCh channels, at most 32.
int moments_lanes(int K) {
  const int need = (K + 1 + kMomCh - 1) / kMomCh;
  int G = 1;
  while (G < need && G < 32) G <<= 1;
  return G;
}

// The moments: G lanes a relation row (moments_lanes), 32 / G rows a
// warp, lane l of a row owning channels l, l + G, ... (kMomCh of them
// a pass; past G kMomCh channels, further passes) of its stab rows
// (w | v^T):
// channel 0 is the lin sum, channel c >= 1 qB and sB of factor c - 1, so
// lin takes the same pass as the factors (at K = 20: 8 lanes of 3
// channels, 4 rows a warp).  A row writes qB_f at f, lin at K and, from
// its first lane, sumsB at K + 1 of its row of stride ldm: each lane sums
// the sB of its channels in ascending c, then the lanes' sums meet by a
// segmented shuffle (lane l adds lane l + d for d = 1, 2, 4, ...), the
// order bs_rel_moments_plain takes too.  A row's ids and x come kHold a lane, lane l
// taking positions l, l + G, ... of a round (coalesced loads), and are
// handed to the row's lanes by shuffles, one shuffle serving every row of
// the warp; kMomBatch positions' gathers are issued before their sums.
// Each channel adds its positions in ascending p, as the twin does.  (A
// warp a row, a lane a channel, is bound by its shuffles on the H100: two
// a position for one row, where here two serve 32 / G rows; four
// channels a lane, at K = 20 also 8 lanes and 4 rows a warp, took more
// registers and ran about 1.2x slower.)
template <int G>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    rel_moments_kernel(const int* __restrict__ rids,
                       const float* __restrict__ rvals, int64_t R, int Pr,
                       const float* __restrict__ stab, int64_t off, int K,
                       int k1, float* __restrict__ out, int64_t ldm) {
  constexpr int kRows = 32 / G;  // rows a warp
  constexpr int kHold = kRows < 8 ? kRows : 8;  // positions a lane holds
  constexpr int kRound = G * kHold;  // positions a round
  const int lane = threadIdx.x & 31;
  const int slot = lane / G;
  const int gl = lane % G;
  const int64_t rho0 =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      kRows;
  if (rho0 >= R) return;  // the whole warp leaves
  const int64_t rho = rho0 + slot;
  const bool live = rho < R;
  const int64_t ld = K + 1;
  const int C = K + 1;
  const float* tab = stab + off * ld;
  const int* rid = rids + rho * Pr;
  const float* rx = rvals + rho * Pr;
  float* o = out + rho * ldm;
  float sb = 0.f;  // this lane's share of sumsB
  for (int c0 = 0; c0 < C; c0 += G * kMomCh) {
    // the same warp-wide
    const int nch = min(kMomCh, (C - c0 + G - 1) / G);
    int cs[kMomCh];
    bool on[kMomCh];
    float s[kMomCh], s2[kMomCh];
#pragma unroll
    for (int i = 0; i < kMomCh; ++i) {
      cs[i] = c0 + gl + G * i;
      on[i] = live && cs[i] < C && (cs[i] > 0 || k1);
      s[i] = s2[i] = 0.f;
    }
    for (int p0 = 0; p0 < Pr; p0 += kRound) {
      int hid[kHold];
      float hx[kHold];
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int p = p0 + gl + G * h;
        const bool in = live && p < Pr;
        hid[h] = in ? rid[p] : 0;
        hx[h] = in ? rx[p] : 0.f;
      }
#pragma unroll
      for (int b0 = 0; b0 < kRound; b0 += kMomBatch) {
        if (p0 + b0 < Pr) {
          float gv[kMomBatch][kMomCh];
#pragma unroll
          for (int k = 0; k < kMomBatch; ++k) {
            const int p = b0 + k;
            const int64_t id =
                __shfl_sync(svbfm::kFullMask, hid[p / G], slot * G + p % G);
#pragma unroll
            for (int i = 0; i < kMomCh; ++i) {
              gv[k][i] = 0.f;
              if (i < nch && on[i] && p0 + p < Pr)
                gv[k][i] = tab[id * ld + cs[i]];
            }
          }
#pragma unroll
          for (int k = 0; k < kMomBatch; ++k) {
            const int p = b0 + k;
            const float x =
                __shfl_sync(svbfm::kFullMask, hx[p / G], slot * G + p % G);
            if (p0 + p < Pr) {
#pragma unroll
              for (int i = 0; i < kMomCh; ++i) {
                if (i < nch) {
                  const float d = gv[k][i] * x;
                  s[i] += d;
                  s2[i] += d * d;
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMomCh; ++i) {
      if (live && cs[i] < C) {  // qB at c - 1, lin at K
        if (cs[i] > 0) {
          o[cs[i] - 1] = s[i];
          sb += s2[i];
        } else {
          o[K] = s[i];
        }
      }
    }
  }
  for (int d = 1; d < G; d <<= 1) {
    const float t = __shfl_down_sync(svbfm::kFullMask, sb, d);
    if (gl + d < G) sb += t;
  }
  if (live && gl == 0) o[K + 1] = sb;
}

// One kVec-float chunk of the resync at factor f of data row n joined to
// relation row j (any of dy, qb1, qb0, e may be nullptr; q is present
// where qb1 is): its loads issued together, then de += dy + (q - qB0) dq
// and q += dq, dq = qB1 - qB0.
template <int kVec>
__device__ __forceinline__ void resync_chunk(
    int64_t n, int64_t j, int f, int F, const float* __restrict__ dy,
    const float* __restrict__ qb1, int64_t ld1, const float* __restrict__ qb0,
    float* __restrict__ q, bool with_e, float& de) {
  float d[kVec], b1[kVec], b0[kVec], qv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) d[i] = b1[i] = b0[i] = qv[i] = 0.f;
  if (dy != nullptr) load_vec<kVec>(dy + j * F + f, d);
  if (qb1 != nullptr) {
    load_vec<kVec>(qb1 + j * ld1 + f, b1);
    load_vec<kVec>(q + n * F + f, qv);
  }
  if (qb0 != nullptr) load_vec<kVec>(qb0 + j * F + f, b0);
#pragma unroll
  for (int i = 0; i < kVec; ++i) de += d[i];
  if (qb1 == nullptr) return;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float dq = b1[i] - b0[i];
    if (with_e) de += (qv[i] - b0[i]) * dq;
    qv[i] += dq;
  }
  store_vec<kVec>(q + n * F + f, qv);
}

// The resync at F >= 2: G lanes a data row over its F / kVec chunks of
// kVec floats (G = min(F / kVec, 32); 5 lanes at F = 20, six rows a warp),
// 32 / G rows a warp (mirrored by kernels/bs_forward.py:resync_plan).  The
// row's first lane reads join[n] once and passes it on; each lane issues
// the loads of its chunks of dy, qB1, qB0 and q together; the e term is
// folded by a segmented shuffle over the row's lanes (a fixed order).
template <int kVec>
__global__ void __launch_bounds__(kResyncThreads)
    resync_chunks_kernel(const int* __restrict__ join, int64_t N, int F,
                         int G, const float* __restrict__ dy,
                         const float* __restrict__ qb1, int64_t ld1,
                         const float* __restrict__ qb0,
                         float* __restrict__ q, float* __restrict__ e) {
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / G;  // rows a warp
  const int slot = lane / G;
  const int gl = lane - slot * G;
  const int64_t n0 =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      rpw;
  if (n0 >= N) return;  // the whole warp leaves
  const int64_t n = n0 + slot;
  const bool live = slot < rpw && n < N;
  int jl = 0;
  if (live && gl == 0) jl = join[n];
  const int64_t j = __shfl_sync(svbfm::kFullMask, jl, slot * G);
  const int C = F / kVec;
  float de = 0.f;
  if (live) {
    for (int c = gl; c < C; c += G)
      resync_chunk<kVec>(n, j, c * kVec, F, dy, qb1, ld1, qb0, q,
                         e != nullptr, de);
  }
  if (e == nullptr) return;
  for (int o = 1; o < G; o <<= 1) {
    const float t = __shfl_down_sync(svbfm::kFullMask, de, o);
    if (gl + o < G) de += t;
  }
  if (live && gl == 0) e[n] += de;
}

// The resync at F = 1 (the factor-sequential path; the w resync, dy
// alone): kResyncRows rows a thread, their join, q and e read and written
// kResyncRows at a time where the bases allow it (vec4) and the rows are
// whole, one by one at the ragged end; the gathers of all the thread's
// rows issued before the arithmetic.
__global__ void __launch_bounds__(kResyncThreads)
    resync_rows_kernel(const int* __restrict__ join, int64_t N,
                       const float* __restrict__ dy,
                       const float* __restrict__ qb1, int64_t ld1,
                       const float* __restrict__ qb0, float* __restrict__ q,
                       float* __restrict__ e, int vec4) {
  const int64_t n0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kResyncRows;
  if (n0 >= N) return;
  const bool whole = vec4 && n0 + kResyncRows <= N;
  const int nr = static_cast<int>(N - n0 < kResyncRows ? N - n0
                                                       : kResyncRows);
  int j[kResyncRows];
  float qv[kResyncRows], ev[kResyncRows];
#pragma unroll
  for (int i = 0; i < kResyncRows; ++i) {
    j[i] = 0;
    qv[i] = ev[i] = 0.f;
  }
  if (whole) {
    const int4 t = *reinterpret_cast<const int4*>(join + n0);
    j[0] = t.x;
    j[1] = t.y;
    j[2] = t.z;
    j[3] = t.w;
    if (qb1 != nullptr) load_vec<4>(q + n0, qv);
    if (e != nullptr) load_vec<4>(e + n0, ev);
  } else {
#pragma unroll
    for (int i = 0; i < kResyncRows; ++i) {
      if (i < nr) {
        j[i] = join[n0 + i];
        if (qb1 != nullptr) qv[i] = q[n0 + i];
        if (e != nullptr) ev[i] = e[n0 + i];
      }
    }
  }
  float d[kResyncRows], b1[kResyncRows], b0[kResyncRows];
#pragma unroll
  for (int i = 0; i < kResyncRows; ++i) {
    const int64_t ji = j[i];
    const bool in = i < nr;
    d[i] = in && dy != nullptr ? dy[ji] : 0.f;
    b1[i] = in && qb1 != nullptr ? qb1[ji * ld1] : 0.f;
    b0[i] = in && qb0 != nullptr ? qb0[ji] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kResyncRows; ++i) {
    const float dq = b1[i] - b0[i];
    float de = d[i];
    if (qb1 != nullptr) {
      if (e != nullptr) de += (qv[i] - b0[i]) * dq;
      qv[i] += dq;
    }
    ev[i] += de;
  }
  if (whole) {
    if (qb1 != nullptr) store_vec<4>(q + n0, qv);
    if (e != nullptr) store_vec<4>(e + n0, ev);
  } else {
#pragma unroll
    for (int i = 0; i < kResyncRows; ++i) {
      if (i < nr) {
        if (qb1 != nullptr) q[n0 + i] = qv[i];
        if (e != nullptr) e[n0 + i] = ev[i];
      }
    }
  }
}

inline unsigned warp_blocks(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// moments rows (qB | lin | sumsB) [R, K+2] at row stride ldm of one
// relation from stab [D_all, 1+K] rows off + id.
SVBFM_EXPORT int svbfm_bs_rel_moments(const int* rids, const float* rvals,
                                      int64_t R, int Pr, const float* stab,
                                      int64_t off, int K, int k1, float* out,
                                      int64_t ldm, cudaStream_t stream) {
  if (ldm < K + 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = moments_lanes(K);
  const int64_t warps = (R + 32 / G - 1) / (32 / G);
  auto go = [&](auto g) {
    constexpr int kG = decltype(g)::value;
    rel_moments_kernel<kG>
        <<<warp_blocks(warps), 32 * kWarpsPerBlock, 0, stream>>>(
            rids, rvals, R, Pr, stab, off, K, k1, out, ldm);
  };
  switch (G) {
    case 1: go(std::integral_constant<int, 1>()); break;
    case 2: go(std::integral_constant<int, 2>()); break;
    case 4: go(std::integral_constant<int, 4>()); break;
    case 8: go(std::integral_constant<int, 8>()); break;
    case 16: go(std::integral_constant<int, 16>()); break;
    default: go(std::integral_constant<int, 32>()); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The resync's chunk width at F >= 2: the widest of 4, 2, 1 floats that
// divides F and ld1 and to whose size dy, qB1, qB0 and q are aligned
// (mirrored by kernels/bs_forward.py:resync_plan).
static int resync_vec(int F, int64_t ld1, const float* dy, const float* qb1,
                      const float* qb0, const float* q) {
  for (int v = 4; v > 1; v /= 2) {
    const uintptr_t b = sizeof(float) * v;
    if (F % v == 0 && (qb1 == nullptr || ld1 % v == 0) && aligned(dy, b) &&
        aligned(qb1, b) && aligned(qb0, b) && aligned(q, b))
      return v;
  }
  return 1;
}

// The resync of q [N, F] and e [N] through join [N]; any of dy [R, F], qb1
// (rows of stride ld1), qb0 [R, F] and e may be nullptr, q where qb1 is
// (see the top): F = 1 kResyncRows rows a thread, F >= 2 lanes over
// chunks of a row.
SVBFM_EXPORT int svbfm_bs_resync(const int* join, int64_t N, int F,
                                 const float* dy, const float* qb1,
                                 int64_t ld1, const float* qb0, float* q,
                                 float* e, cudaStream_t stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaSuccess);
  if (qb1 != nullptr && q == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 1) {
    const int vec4 = aligned(join, 16) && (qb1 == nullptr || aligned(q, 16)) &&
                     aligned(e, 16);
    const int64_t threads = (N + kResyncRows - 1) / kResyncRows;
    resync_rows_kernel<<<static_cast<unsigned>((threads + kResyncThreads -
                                                1) / kResyncThreads),
                         kResyncThreads, 0, stream>>>(join, N, dy, qb1, ld1,
                                                      qb0, q, e, vec4);
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = resync_vec(F, ld1, dy, qb1, qb0, q);
  const int G = F / vec < 32 ? F / vec : 32;
  const int64_t warps = (N + 32 / G - 1) / (32 / G);
  const unsigned blocks = static_cast<unsigned>(
      (warps * 32 + kResyncThreads - 1) / kResyncThreads);
  if (vec == 4) {
    resync_chunks_kernel<4><<<blocks, kResyncThreads, 0, stream>>>(
        join, N, F, G, dy, qb1, ld1, qb0, q, e);
  } else if (vec == 2) {
    resync_chunks_kernel<2><<<blocks, kResyncThreads, 0, stream>>>(
        join, N, F, G, dy, qb1, ld1, qb0, q, e);
  } else {
    resync_chunks_kernel<1><<<blocks, kResyncThreads, 0, stream>>>(
        join, N, F, G, dy, qb1, ld1, qb0, q, e);
  }
  return static_cast<int>(cudaGetLastError());
}
