// K1: FM score and VBFM T-term forward over the padded row layout.
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
#include <algorithm>
#include <type_traits>

#include "svbfm_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps: the SMs refill sooner than with 8
constexpr int kChunk = 4;  // factors a lane takes a pass
constexpr int kPos = 4;    // positions whose loads go out together (any P)

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

template <int W, int kP, bool kT>
__global__ void __launch_bounds__(kThreads)
    fm_rows_kernel(const float* __restrict__ tab, int64_t ld, int K,
                   const float* __restrict__ base0,
                   const int* __restrict__ ids,
                   const float* __restrict__ vals, int64_t N, int P_any,
                   int TPR, float* __restrict__ out) {
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
  float part = 0.f, b0 = 0.f;
  if (valid) {
    if (j == 0) b0 = *base0;  // in flight beside the row's loads
    const int* nid = ids + n * P;
    const float* nx = vals + n * P;
    int id[kB];
    float xv[kB];
    if constexpr (kP > 0) {  // the row's ids and x, once
#pragma unroll
      for (int b = 0; b < kB; ++b) id[b] = nid[b], xv[b] = nx[b];
    }
    // lane 0's first pass also takes the linear channel; at K = 0 it is
    // the only pass
    for (int ch = j; ch < G || ch == 0; ch += 32) {
      const bool lin = ch == 0;
      const bool fac = ch < G;
      const int f0 = ch * kChunk;
      const int n_in = K - f0;
      float s[kChunk], s2[kChunk], s3[kChunk], l = 0.f;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) s[k] = s2[k] = s3[k] = 0.f;
      for (int p0 = 0; p0 < P; p0 += kB) {
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
      if (fac) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          part += kT ? 0.5f * s2[k] * s2[k] + s2[k] * s[k] - s3[k]
                     : 0.5f * (s[k] * s[k] - s2[k]);
        }
      }
      if (lin) part += l;
    }
  }
  for (int d = 1; d < TPR; d <<= 1) {
    const float t = __shfl_down_sync(svbfm::kFullMask, part, d);
    if (j + d < TPR) part += t;
  }
  if (valid && j == 0) out[n] = b0 + part;
}

// The loads' width (mirrored by kernels/fm_forward.py:fm_plan): 4 floats
// where K and ld are multiples of 4 and the factor channels' base, tab + 1,
// is 16-byte aligned (the tables ops/forward.py builds), else 1.
int load_width(const float* tab, int64_t ld, int K) {
  const bool wide = K > 0 && K % 4 == 0 && ld % 4 == 0 &&
                    svbfm::aligned(tab + 1, 16);
  return wide ? 4 : 1;
}

// Lanes a row (mirrored by kernels/fm_forward.py:fm_plan).
int row_lanes(int K) {
  return std::max(1, std::min((K + kChunk - 1) / kChunk, 32));
}

template <bool kT>
int launch(const float* tab, int64_t ld, int K, const float* base0,
           const int* ids, const float* vals, int64_t N, int P, float* out,
           cudaStream_t stream) {
  const int TPR = row_lanes(K);
  const int64_t warps = (N + 32 / TPR - 1) / (32 / TPR);
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  auto go = [&](auto w) {
    constexpr int kW = decltype(w)::value;
    auto kernel = P == 2 ? fm_rows_kernel<kW, 2, kT>
                         : fm_rows_kernel<kW, 0, kT>;
    kernel<<<blocks, kThreads, 0, stream>>>(tab, ld, K, base0, ids, vals, N,
                                            P, TPR, out);
  };
  if (load_width(tab, ld, K) == 4) {
    go(std::integral_constant<int, 4>());
  } else {
    go(std::integral_constant<int, 1>());
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab [D, 1+K] = (w | v^T) at row stride ld; w0 a device scalar; out [N]
SVBFM_EXPORT int svbfm_fm_scores(const float* tab, int64_t ld, int K,
                                 const float* w0, const int* ids,
                                 const float* vals, int64_t N, int P,
                                 float* out, cudaStream_t stream) {
  return launch<false>(tab, ld, K, w0, ids, vals, N, P, out, stream);
}

// tab [D, 1+2K] = (sw | m^T | s^T) at row stride ld; s0 a device scalar;
// out [N]
SVBFM_EXPORT int svbfm_fm_t_terms(const float* tab, int64_t ld, int K,
                                  const float* s0, const int* ids,
                                  const float* vals, int64_t N, int P,
                                  float* out, cudaStream_t stream) {
  return launch<true>(tab, ld, K, s0, ids, vals, N, P, out, stream);
}
