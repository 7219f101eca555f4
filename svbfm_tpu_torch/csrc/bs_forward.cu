// X10d: the block-structure (BS) forward pass and the data-row resync of
// the native relational Gibbs/ALS sampler.
//
// Replaces the XLA gather chains of svbfm_tpu/learners/mcmc_bs.py:
//   bs_rel_moments: the relation-row moments of bs_scores (:230-234,
//     :251-258) and the qB of every factor at the v sweep's entry
//     (:700-708): per relation row rho, over its row-layout positions,
//       lin = sum w x,  qB_f = sum v_f x,  sB_f = sum (v_f x)^2;
//   bs_scores: the joined score of each data row (:215-268),
//       y = w0 + sum_p w x + sum_r lin_r[j_r]
//           + 1/2 sum_f [(s_f)^2 - s2_f],
//       s_f  = sum_p v_f x + sum_r qB_r,f[j_r],
//       s2_f = sum_p (v_f x)^2 + sum_r sB_r,f[j_r];
//   bs_resync: the data-row resync after a relation sweep (:463-468,
//     :820-824, :689-690), with j = join[n] and qO = q - qB0[j],
//       e += sum_f dy_f[j] + sum_f qO_f (qB1_f[j] - qB0_f[j]),
//       q += qB1[j] - qB0[j];
//     and, with no qB0, dy or e, the q build q += qB1[j] (:490-497).
//
// Layouts: the parameter table stab [D_all, 1+K] = (w | v^T) of K1; a
// relation's row layout rids/rvals [R, Pr] in its local attribute ids,
// which sit at rows off .. off + Dr - 1 of stab; moments [R, 1+2K] =
// (lin | qB | sB); q [N, F] row-major; dy, qB0 [R, F]; qB1 rows of
// stride ld1 (the qB channels of X10b's relation table).  bs_scores takes
// any number of relations: their joins and moment tables arrive as two
// device arrays of nrel pointers, which the wrapper builds once per set of
// tensors, and every relation's qB adds into one s_f before it is squared.
//
// Bound: bytes.  bs_scores reads each data row's ids, values and table
// rows and one moments row per relation at a data-dependent address
// (1+2K floats); one warp per row, lanes over factors, as K1.  bs_resync
// reads each data row's join and q (and e) and gathers the joined dy, qB1
// and qB0 rows from tables that L2 holds: its byte bound is q's read and
// write (160 MB at 1M rows, F = 20), but the gathers' L2 sectors (three
// a table a row at F = 20, one at F = 1, at random rows) take as long on
// the H100 (the q build, one table, runs near the byte bound; the full
// resync, three, does not).  Its lanes go over 16-byte chunks of a row
// where F, ld1 and the bases allow, 8- or 4-byte ones where not, several
// rows a warp (resync_chunks_kernel), or at F = 1 over four rows a thread
// with 16-byte loads of join, q and e (resync_rows_kernel).
#include "svbfm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kResyncThreads = 256;
constexpr int kResyncRows = 4;  // data rows a thread at F = 1

__global__ void rel_moments_kernel(const int* __restrict__ rids,
                                   const float* __restrict__ rvals,
                                   int64_t R, int Pr,
                                   const float* __restrict__ stab,
                                   int64_t off, int K, int k1,
                                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t rho =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (rho >= R) return;
  const int64_t ld = K + 1;
  const int* rid = rids + rho * Pr;
  const float* rx = rvals + rho * Pr;
  float* o = out + rho * (1 + 2 * K);
  for (int f = lane; f < K; f += 32) {
    float qb = 0.f, sb = 0.f;
    for (int p = 0; p < Pr; ++p) {
      const float d = stab[(off + rid[p]) * ld + 1 + f] * rx[p];
      qb += d;
      sb += d * d;
    }
    o[1 + f] = qb;
    o[1 + K + f] = sb;
  }
  if (lane == 0) {
    float lin = 0.f;
    if (k1)
      for (int p = 0; p < Pr; ++p) lin += stab[(off + rid[p]) * ld] * rx[p];
    o[0] = lin;
  }
}

__global__ void bs_scores_kernel(const float* __restrict__ stab, int K,
                                 const float* __restrict__ w0,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ vals, int64_t N,
                                 int P, int nrel,
                                 const int* const* __restrict__ joins,
                                 const float* const* __restrict__ moms,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const int64_t ld = K + 1;
  const int64_t ldm = 1 + 2 * K;
  const int* rid = ids + n * P;
  const float* rx = vals + n * P;
  float part = 0.f;
  for (int f = lane; f < K; f += 32) {
    float s = 0.f, s2 = 0.f;
    for (int p = 0; p < P; ++p) {
      const float d = stab[rid[p] * ld + 1 + f] * rx[p];
      s += d;
      s2 += d * d;
    }
    for (int r = 0; r < nrel; ++r) {
      const float* m = moms[r] + static_cast<int64_t>(joins[r][n]) * ldm;
      s += m[1 + f];
      s2 += m[1 + K + f];
    }
    part += s * s - s2;
  }
  part = svbfm::warp_sum(part);
  if (lane == 0) {
    float acc = *w0;
    for (int p = 0; p < P; ++p) acc += stab[rid[p] * ld] * rx[p];
    for (int r = 0; r < nrel; ++r)
      acc += moms[r][static_cast<int64_t>(joins[r][n]) * ldm];
    out[n] = acc + 0.5f * part;
  }
}

// kVec floats from p into o (kVec = 4, 2, 1: a 16-, 8- or 4-byte load; p
// aligned to it), and back.
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (kVec == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (kVec == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* o) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    *p = o[0];
  }
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

// moments [R, 1+2K] of one relation from stab [D_all, 1+K] rows off + id.
SVBFM_EXPORT int svbfm_bs_rel_moments(const int* rids, const float* rvals,
                                      int64_t R, int Pr, const float* stab,
                                      int64_t off, int K, int k1, float* out,
                                      cudaStream_t stream) {
  rel_moments_kernel<<<warp_blocks(R), 32 * kWarpsPerBlock, 0, stream>>>(
      rids, rvals, R, Pr, stab, off, K, k1, out);
  return static_cast<int>(cudaGetLastError());
}

// scores [N] from the main rows ids/vals [N, P] and nrel relations: joins
// (a device array of nrel pointers to int [N]) and moms (a device array of
// nrel pointers to [R_r, 1+2K]).
SVBFM_EXPORT int svbfm_bs_scores(const float* stab, int K, const float* w0,
                                 const int* ids, const float* vals, int64_t N,
                                 int P, int nrel, const int* const* joins,
                                 const float* const* moms, float* out,
                                 cudaStream_t stream) {
  if (nrel < 0) return static_cast<int>(cudaErrorInvalidValue);
  bs_scores_kernel<<<warp_blocks(N), 32 * kWarpsPerBlock, 0, stream>>>(
      stab, K, w0, ids, vals, N, P, nrel, joins, moms, out);
  return static_cast<int>(cudaGetLastError());
}

static bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;  // nullptr: aligned
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
