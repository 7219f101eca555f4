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
//        (svbfm::warp_sequential_draws, the code X8a runs).
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
// 3F + 2 + P channels (1,088 bytes at F = 20) per real entry; X10c reads
// each relation row whole (wcc, [R, 210] at F = 20, for the weq matvec)
// and its positions' ptab rows, and writes qB, we, weq and dy, in every bin.
//
// Design.  X10a runs a whole join plan in one launch: its buckets are laid
// end to end in the plan table (kPlanCols int64 a bucket, built once per
// plan by the wrapper), where each block or warp finds its bucket, so a
// relation pays one launch, not one a bucket.  Three forms, chosen by F
// (kernels/bs_sweep.py:join_form).  2 <= F <= 32 (1 + 2F + P channels,
// 251 at F = 20): a warp a relation row, the warps of a persistent grid
// walking the plan's rows; the warp stages only a row's gathered entries,
// their q rows by cp.async, the next round's in flight while it sums this
// one, and each lane adds them into the 4 x 4 Gram tiles it owns in
// registers (join_agg_warp_kernel).  F > 32 (628 to 32,129 channels): the
// same tiles spread over a block a row, the blocks of a persistent grid
// walking the rows, the next rows' gathers in flight
// (join_agg_block_kernel).  F <= 1 (1 or 4 channels, the relation w sweep
// and the factor-sequential path), where a block a row would leave all but one
// thread idle: G lanes a relation row, G the next power of two >= L capped
// at 32, many rows a block; the lanes stride over the row's entries
// (coalesced reads of rows and x), keep the channel sums in registers and
// end with a butterfly of __shfl_xor_sync over the G lanes: no shared
// memory, no barrier, and a fixed order of the sums, so the result is
// deterministic.  In all three a padding slot (x = 0) is gathered only
// where svbfm::PadRow says, so a non-finite e or q at the pad row gives
// the twin's NaN.
// X10b: its form is a function of F and the bucket's L
// (kernels/bs_sweep.py:draw_form); the sums' order is fixed in each, so
// two launches give the same bits, and each ends in the exact draw by one
// warp (svbfm::warp_sequential_draws: corrections in registers, a shuffle
// a factor, no barrier; 1, 2, 4 or 10 factors a lane by F).  L <= 32 (the
// one-hot buckets, 8 slots and one real entry): at F >= 2 a warp a column,
// or 8 lanes a column where L <= 8 and F <= 24, several columns a block;
// the lanes hold the column's slots, stage its real entries' rows E at a
// time in the warp's slice of shared memory with 16-byte cp.async copies,
// add them into the sums each lane owns and draw.  At F <= 1 (the w sweep and
// the factor-sequential path) G lanes a column, G the next power of two
// >= L, and a butterfly.  L > 32 (the attribute-slot buckets: two columns
// of ~36k real entries in 64k slots): a block per (column, split), each
// column's real entries (known on the host when the plan is built, never
// read back at launch) split S ways, so no block reads padding.  At F >= 2
// the block stages T whole relation rows a tile (wcc included; T = 25 at
// F = 20, so that four blocks share an SM) with cp.async, double-buffered, so the next tile's
// gathers are in flight while the owner threads add this one from shared
// memory; past the widths where two tiles of whole rows fit, the rows go
// without wcc and the owners read it from L2.  At F <= 1 the threads
// stride over the entries.  With S > 1 the last block of a column to
// finish (a done-counter) adds the S partials in a fixed order and
// draws.  X10c: its form is a function of F (kernels/bs_sweep.py:
// patch_plan).  At F <= 1 (the w sweep and the factor-sequential path) a
// thread a relation row, the row (2 or 6 floats) in registers.  At F >= 2
// the row's lanes stage it whole in shared memory with 16-byte copies
// (coalesced, where ld and the base allow), so that the wcc matvec reads
// the triangle from there, not in partial sectors from device memory:
// G lanes a row, G the next power of two >= F, 32 / G rows a warp
// (F <= 32, a kernel built for each F, so that the matvec's offsets are
// constants; at F = 20 all 32 lanes copy the row, the 20 factor lanes
// compute and write), the blocks the card holds at once each walking rows
// with the next row's copies in flight;
// or a block a row past F = 32, where a row outgrows a warp's share
// (32,381 floats at F = 251).  The positions' ids, x and ptab rows are
// read before the arithmetic; the positions run in order, the sums in a
// fixed order.
#include <algorithm>

#include "mcmc_draw.cuh"

namespace {

constexpr int kNarrowThreads = 256;  // X10a at F <= 1
// X10a's plan table, int64 [nb, kPlanCols], a row a bucket of the join
// plan: rows, x and cols pointers, C, L, G (the F <= 1 form's lanes a
// relation row) and the bucket's first block (F <= 1) or first relation
// row (F >= 2) (mirrored by kernels/bs_sweep.py:join_plan_rows)
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
    const svbfm::PadRow pr(crow, cx, L);
#pragma unroll 4
    for (int l = lane; l < L; l += G) {
      // the row id is read beside x, from sectors the lanes read anyway,
      // so that the gather waits on one load, not two
      const float xv = cx[l];
      const int r = crow[l];
      if (!pr.gathers(l, r, xv)) continue;
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

// cp.async: a kBytes copy from device memory to shared memory that does not
// wait in registers; visible after cp_async_wait_all() and a barrier.
// 16-byte copies bypass L1 (.cg) unless kL1: rows many blocks read at
// once (X10c's ptab rows of a bin's few columns) are kept in L1 (.ca).
template <int kBytes, bool kL1 = false>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16 && !kL1) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// X10a at 2 <= F <= kAggMaxF: a warp a relation row, the warps the card
// holds at once (a persistent grid), warp w taking rows w, w + warps, ...
// of the plan's buckets laid end to end, each row in rounds of kAggRound
// slots.  A round: the warp reads its slots (coalesced), keeps the
// gathered ones (svbfm::PadRow) by a ballot and stages them, compacted,
// in one of its kAggBufs shared-memory buffers: entry i holds
//   t = q_0 .. q_{F-1} | e | 1   (kS floats, F + 2 <= kS, kS % 8 == 0)
// and its x beside it, q by cp.async (16-, 8- or 4-byte copies, as F and
// q's base allow), e and the row's qB0 by 4-byte ones.  The rounds are
// pipelined: each round's gathers are issued kAggBufs - 1 rounds before
// it is summed, the slots of the round after those are on their way, so
// a warp waits on neither the row ids nor the gathers of the round it
// sums (the gathers, of 80-byte q rows at random, not their bytes, bound
// the kernel: with one round in flight it ran at the latency of each).
// At its turn a round becomes qO = q - qB0 in place, and every channel is
// a cell (i <= j) of the Gram matrix sum t_i (t_j x) over the entries
// (e x = t_F t_{F+1} x, e qO_f x = t_f t_F x, qO_f x = t_f t_{F+1} x,
// qO_f qO_g x = t_f t_g x); lane l owns 4 x 4 tiles of its upper triangle
// (tiles l and l + 32: 21 tiles at F = 20), so an entry is two 16-byte
// shared-memory loads, four products by x and 16 FMAs into registers a
// tile, where a sum a lane would take two loads an FMA.  The entries are
// added four a step (zero-padded to a multiple of four), in slot order, so
// two launches give the same bits.  After a row's last round each lane
// puts its cells at their channels in the buffer just summed, and the
// warp writes the row's CH sums out in consecutive 16-byte streaming
// stores where the row allows (4-byte stores straight from the tiles, to
// scattered channels, ran 30-35 us slower at F = 20 on the H100).  No barrier: a warp shares nothing with
// the others.
constexpr int kAggWarps = 4;
constexpr int kAggRound = 32;
constexpr int kAggBufs = 3;
constexpr int kAggMaxF = 32;

// Floats of one of a warp's buffers: kAggRound entries of kS floats, their
// x and row ids, the row's qB0 (kS floats) and a header (the entries, -1
// past the warp's last round; whether the round ends its row; the row's
// id, two ints) (mirrored by kernels/bs_sweep.py:join_agg_smem).
__host__ __device__ constexpr int agg_buf(int kS) {
  return kAggRound * (kS + 2) + kS + 4;
}

// The channel of Gram cell (i, j), i <= j, of the warp form's staged
// indices (qO_0 .. qO_{F-1} | e | 1), or -1 where it is none (e e x, x,
// the padding past F + 1).
__device__ inline int agg_cell_channel(int i, int j, int F) {
  if (j < F) return 1 + 2 * F + i * F - i * (i - 1) / 2 + (j - i);
  if (j == F) return i < F ? 1 + i : -1;
  if (j == F + 1) return i < F ? 1 + F + i : (i == F ? 0 : -1);
  return -1;
}

// Waits until at most kPending of this thread's cp.async groups are
// pending.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The bucket of relation row g of a plan whose buckets' rows are laid end
// to end (column 6: the bucket's first row); g never decreases, so the
// walk only goes forward.
struct AggBuckets {
  const int64_t* plan;
  int nb, b = -1;
  int64_t first = 0, end = 0;
  const int* rows = nullptr;
  const float* x = nullptr;
  const int* cols = nullptr;
  int L = 0;
  __device__ void seek(int64_t g) {
    while (g >= end && b + 1 < nb) {
      const int64_t* p = plan + ++b * kPlanCols;
      first = p[6];
      end = first + p[3];
      rows = reinterpret_cast<const int*>(p[0]);
      x = reinterpret_cast<const float*>(p[1]);
      cols = reinterpret_cast<const int*>(p[2]);
      L = static_cast<int>(p[4]);
    }
  }
};

// One round as the warp reads it: this lane's slot (l, r, x), the row's
// relation row id and pad row, and where the round sits in the row.
struct AggRound {
  bool valid = false, last = false, pad = false;
  int L = 0, l = 0, r = 0, rl = 0;
  float x = 0.f;
  int64_t rho = 0;
};

template <int kS, int kT>
__global__ void __launch_bounds__(32 * kAggWarps) join_agg_warp_kernel(
    const int64_t* __restrict__ plan, int nb, int64_t nrows,
    const float* __restrict__ e, const float* __restrict__ q, int F, int vec,
    float* __restrict__ rtab) {
  constexpr int kB = kS / 4;  // 4-blocks a side of the Gram matrix
  constexpr int kTiles = kB * (kB + 1) / 2;
  constexpr int kBuf = agg_buf(kS);
  extern __shared__ float4 agg_smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kAggWarps;
  float* const slice =
      reinterpret_cast<float*>(agg_smem4) + warp * kAggBufs * kBuf;
  const int64_t ld = RelLayout(F).ld;
  const int CH = agg_channels(F);  // <= kAggRound kS: an entries area
  // this lane's tiles (row block bi, column block bj >= bi, numbered
  // row-major over the upper triangle); a lane without one sums tile 0
  // and writes nothing
  int bi[kT], bj[kT];
  float acc[kT][16];
#pragma unroll
  for (int s = 0; s < kT; ++s) {
    int tile = lane + 32 * s;
    bi[s] = bj[s] = 0;
    if (tile < kTiles) {
      int r = 0;
      while (tile >= kB - r) tile -= kB - r++;
      bi[s] = r;
      bj[s] = r + tile;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[s][k] = 0.f;
  }
  // the qO pass: lane (bo, bc) takes chunk bc of entries bo, bo + per, ...
  const int nv = F / vec;
  const int per = 32 / nv;
  const int bo = lane / nv;
  const int bc = lane - bo * nv;

  // the warp's stream of rounds: rows g, g + nwarps, ...; l0 the next
  // round's first slot
  AggBuckets bks{plan, nb};
  int64_t g = static_cast<int64_t>(blockIdx.x) * kAggWarps + warp;
  int l0 = 0;
  AggRound row;  // the row being read: its rho and pad row
  auto read = [&](AggRound& rd) {  // the next round's slots, in flight
    rd.valid = g < nrows;
    if (!rd.valid) return;
    bks.seek(g);
    const int64_t c = g - bks.first;
    const int L = bks.L;
    const int* crow = bks.rows + c * L;
    const float* cx = bks.x + c * L;
    rd.L = L;
    rd.l = l0 + lane;
    rd.r = rd.l < L ? crow[rd.l] : 0;
    rd.x = rd.l < L ? cx[rd.l] : 0.f;
    if (l0 == 0) {
      row.rho = bks.cols[c];
      row.rl = L > 0 ? crow[L - 1] : 0;
      row.pad = L > 0 && cx[L - 1] == 0.f;
    }
    rd.rho = row.rho;
    rd.rl = row.rl;
    rd.pad = row.pad;
    l0 += kAggRound;
    rd.last = l0 >= L;
    if (rd.last) {
      g += nwarps;
      l0 = 0;
    }
  };
  // stage round rd into buffer buf: its gathered entries compacted, x, the
  // header, and e, qB0 and q by cp.async (one commit group)
  auto stage = [&](const AggRound& rd, float* buf) {
    float* xs = buf + kAggRound * kS;
    int* s_r = reinterpret_cast<int*>(xs + kAggRound);
    float* qbs = reinterpret_cast<float*>(s_r + kAggRound);
    int* hdr = reinterpret_cast<int*>(qbs + kS);
    const bool keep = rd.valid && rd.l < rd.L &&
                      svbfm::PadRow(rd.rl, rd.L, rd.pad).gathers(rd.l, rd.r,
                                                                 rd.x);
    const unsigned m = __ballot_sync(svbfm::kFullMask, keep);
    const int n = __popc(m);
    if (keep) {
      const int i = __popc(m & ((1u << lane) - 1));
      float* t = buf + i * kS;
      s_r[i] = rd.r;
      xs[i] = rd.x;
      cp_async<4>(t + F, e + rd.r);
      t[F + 1] = 1.f;
    }
    const int n4 = (n + 3) & ~3;
    for (int i = n * kS + lane; i < n4 * kS; i += 32) buf[i] = 0.f;
    if (lane >= n && lane < n4) xs[lane] = 0.f;
    if (rd.valid && lane < F) cp_async<4>(qbs + lane, rtab + rd.rho * ld + lane);
    if (lane == 0) {
      hdr[0] = rd.valid ? n : -1;
      hdr[1] = rd.last;
      hdr[2] = static_cast<int>(rd.rho);
      hdr[3] = static_cast<int>(rd.rho >> 32);
    }
    __syncwarp();
    for (int i = lane; i < n * nv; i += 32) {
      const int k = i / nv;
      const int ch = i - k * nv;
      const float* src = q + static_cast<int64_t>(s_r[k]) * F + ch * vec;
      float* dst = buf + k * kS + ch * vec;
      if (vec == 4) {
        cp_async<16>(dst, src);
      } else if (vec == 2) {
        cp_async<8>(dst, src);
      } else {
        cp_async<4>(dst, src);
      }
    }
    cp_async_commit();
  };

  AggRound nxt;
  read(nxt);
#pragma unroll
  for (int d = 0; d < kAggBufs - 1; ++d) {
    const AggRound stg = nxt;
    read(nxt);
    stage(stg, slice + d * kBuf);
  }
  for (int i = 0;; ++i) {
    // stage the round kAggBufs - 1 ahead into the buffer summed last, then
    // sum this one
    {
      const AggRound stg = nxt;
      read(nxt);
      __syncwarp();
      stage(stg, slice + (i + kAggBufs - 1) % kAggBufs * kBuf);
    }
    cp_async_wait<kAggBufs - 1>();
    __syncwarp();
    float* const cb = slice + i % kAggBufs * kBuf;
    const float* xs = cb + kAggRound * kS;
    const float* qbs = xs + 2 * kAggRound;
    const int* hdr = reinterpret_cast<const int*>(qbs + kS);
    const int n = hdr[0];
    if (n < 0) break;  // past the warp's last round
    if (bo < per) {
      float qb[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) qb[v] = v < vec ? qbs[bc * vec + v] : 0.f;
      for (int k = bo; k < n; k += per) {
        float* t = cb + k * kS + bc * vec;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < vec) t[v] -= qb[v];
      }
    }
    __syncwarp();
    for (int k = 0; k < n; k += 4) {
      const float4* t4 = reinterpret_cast<const float4*>(cb + k * kS);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float xk = xs[k + u];
#pragma unroll
        for (int s = 0; s < kT; ++s) {
          const float4 a = t4[u * kB + bi[s]];
          const float4 b = t4[u * kB + bj[s]];
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bx[4] = {b.x * xk, b.y * xk, b.z * xk, b.w * xk};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[s][4 * ii + jj] =
                  fmaf(av[ii], bx[jj], acc[s][4 * ii + jj]);
          }
        }
      }
    }
    if (hdr[1]) {  // the row's last round: its cells to their channels in
                   // this buffer's entries, then the CH sums out
      const int64_t rho = static_cast<int64_t>(
          (static_cast<uint64_t>(static_cast<unsigned>(hdr[3])) << 32) |
          static_cast<unsigned>(hdr[2]));
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kT; ++s) {
        const bool mine = lane + 32 * s < kTiles;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 4 * bi[s] + ii, j = 4 * bj[s] + jj;
            const int o = agg_cell_channel(i, j, F);
            if (mine && i <= j && o >= 0) cb[o] = acc[s][4 * ii + jj];
            acc[s][4 * ii + jj] = 0.f;
          }
        }
      }
      __syncwarp();
      float* out = rtab + rho * ld + F;  // streaming: no sum is read back
      if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        const int c4 = CH / 4;
        for (int o = lane; o < c4; o += 32)
          __stcs(reinterpret_cast<float4*>(out) + o,
                 reinterpret_cast<const float4*>(cb)[o]);
        for (int o = 4 * c4 + lane; o < CH; o += 32) __stcs(out + o, cb[o]);
      } else {
        for (int o = lane; o < CH; o += 32) __stcs(out + o, cb[o]);
      }
    }
  }
  cp_async_wait_all();
}

// Calls fn(integral_constant kS, integral_constant kT) with X10a's warp
// form for F (2 <= F <= kAggMaxF): kS the floats of half an entry (the
// next multiple of 8 >= F + 2, mirrored by kernels/bs_sweep.py:
// agg_stride), kT the 4 x 4 tiles of the Gram matrix's upper triangle a
// lane owns (2 past 32 tiles, kS = 40).
template <typename Fn>
decltype(auto) with_agg_form(int F, Fn&& fn) {
  using std::integral_constant;
  if (F <= 6)
    return fn(integral_constant<int, 8>{}, integral_constant<int, 1>{});
  if (F <= 14)
    return fn(integral_constant<int, 16>{}, integral_constant<int, 1>{});
  if (F <= 22)
    return fn(integral_constant<int, 24>{}, integral_constant<int, 1>{});
  if (F <= 30)
    return fn(integral_constant<int, 32>{}, integral_constant<int, 2>{});
  return fn(integral_constant<int, 40>{}, integral_constant<int, 2>{});
}

// X10a past kAggMaxF (33 <= F <= 251, 628 to 32,129 channels a relation
// row): the warp form's Gram tiles spread over a block, a relation row a
// block at a time, the blocks the card holds at once (a persistent grid)
// walking the plan's rows g = blockIdx.x, + gridDim.x, ... in rounds of
// kRound slots.  Bound: bytes, mostly the CH sums written (632 MB at F = 64
// on the 71,567 users' rows); the float32 FMAs, about a quarter of that
// time at F = 64, run on CUDA cores (TF32 would break the 1e-4
// tolerance).  An entry is t = (e | 1 | 0 | 0 | qO | zeros), kS =
// join_stride(F) floats, qO at a 16-byte boundary.  A round: warp 0 reads
// its slots (coalesced) two rounds ahead, and a round later keeps the
// gathered ones (svbfm::PadRow) by a ballot and stages them compacted (row
// id, x, e by cp.async) with the row's qB0 in one of kJoinBufs buffers; a
// round later still every thread issues its share of the entries' q rows
// by 16-byte cp.async, into their t where q's rows are 16-byte aligned,
// else as the raw 16-byte words that hold each row; so while the block
// sums a round the next two rounds' gathers are in flight, across rows
// too (a user's row of ~14 entries is one round: a row a block, the next
// rows prefetched, as many blocks an SM as fit, the round size chosen for
// that).  At its turn a round's t is built (qO = q - qB0: in place, or from
// the raw words into the block's t area), and thread t owns units t,
// t + nt, ... (kU of them) of the Gram upper triangle of t, a unit two
// 4 x 4 tiles over one column block (row blocks 2p, 2p + 1, row-pair-major),
// its 32 kU sums in registers across the row's rounds: an entry is three
// 16-byte shared-memory loads, four products by x and 32 FMAs a unit
// (neighbouring threads on neighbouring column blocks: conflict-free loads,
// the row blocks broadcast; the shared-memory loads, not the FMAs, bound a
// tile a thread).  The entries are added four a step (zero-padded), in
// slot order, so two launches give the same bits.  After a row's last
// round the block puts its cells at their channels in the round's first
// area (stage_cells: with e and 1 first, each row of a tile is a run of
// channels), shifted by the row's 16-byte misalignment, and streams them
// out as 16-byte stores (__stcs) whatever ld is, the ragged ends as 4-byte
// ones, in windows where a row's channels outgrow the area.
constexpr int kJoinBufs = 3;  // rounds staged at once
// the widest blocks at 1 unit a thread, and at 2 or 3 (F <= 260: 1,122
// units), so that no SM sub-partition holds more than 4 (3) of a block's
// warps and a thread may take 128 (168) registers without spills
constexpr int kJoinThreads = 512;
constexpr int kJoinThreadsWide = 384;

// Walks the cells (k, c) of a grid of w columns, row-major, from cell
// `start` on, `step` cells at a time (a thread's share of a block-strided
// loop), without a division in the loop.
struct GridWalk {
  int k, c, dk, dc, w;
  __device__ GridWalk(int start, int step, int w_)
      : k(start / w_), c(start % w_), dk(step / w_), dc(step % w_), w(w_) {}
  __device__ void next() {
    k += dk;
    c += dc;
    if (c >= w) {
      c -= w;
      ++k;
    }
  }
};

// A round as the block form's warp 0 reads it: this lane's slot (l, r, x),
// the row's last slot (rl, xl: its pad row) and relation row, and where the
// round sits in the row.
struct JoinRound {
  bool valid = false, last = false;
  int L = 0, l = 0, r = 0, rl = 0;
  float x = 0.f, xl = 1.f;
  int64_t rho = 0;
};

// kS of the block form: an entry's floats, (e | 1 | 0 | 0 | q_0 .. q_{F-1})
// and zeros to a multiple of 8 (mirrored by kernels/bs_sweep.py:
// join_stride).
__host__ __device__ constexpr int join_stride(int F) {
  return (F + 4 + 7) / 8 * 8;
}

// Puts the 16 sums a[at .. at + 16) of the block form's Gram tile (bi, bj)
// over t = (e | 1 | 0 | 0 | qO) at their channels o, in cb[o + off] where
// that lies in [0, win).  Each row i of the tile is a run of channels
// o = base(i) + j: e qO_m (channel 1 + m) at i = 0, qO_m (1 + F + m) at
// i = 1, qO_m qO_n (1 + 2F + m F - m (m - 1) / 2 + n - m, n >= m) at
// i = 4 + m; e x (channel 0, cell (0, 1)) alone sits in tile (0, 0), whose
// other cells (e e x, x and the zeros) are none, as rows 2, 3, the cells
// below the diagonal and the columns past F + 3.
__device__ __forceinline__ void stage_cells(const float (&a)[32], int at,
                                            int bi, int bj, int F, int off,
                                            int win, float* cb) {
  if (bi == 0 && bj == 0) {
    if (static_cast<unsigned>(off) < static_cast<unsigned>(win))
      cb[off] = a[at + 1];
    return;
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    if (bi == 0 && ii >= 2) continue;
    const int m = 4 * bi + ii - 4;
    const int base = bi > 0 ? 2 * F - 3 + m * F - m * (m + 1) / 2
                            : (ii == 0 ? -3 : F - 3);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * bj + jj;
      const int k = base + j + off;
      if ((jj >= ii || bi != bj) && j < F + 4 &&
          static_cast<unsigned>(k) < static_cast<unsigned>(win))
        cb[k] = a[at + 4 * ii + jj];
    }
  }
}

// The block form's layout at F, by whether q's rows start at 16-byte
// boundaries (kRaw false: F % 4 == 0 and q aligned) or not, in rounds of
// kRound slots (32, or 16 where that lets an SM hold half as many blocks
// again: more rows in flight; see svbfm_bs_join_agg).  A round buffer
// holds kRound entries' areas, then their x, row ids and e, the row's qB0
// (to a float4) and a header (the entries, -1 past the block's last round;
// whether the round ends its row; the row's id, two ints).  Aligned, an
// entry's area is its t itself (join_stride(F) floats), q copied into
// place.  Unaligned, it is the raw span of q: the 16-byte words that hold
// the row (F + 3 floats at most), and the block's one t area (kRound
// entries of t) follows the kJoinBufs buffers.  Either way the round's
// first area stages the row's sums once the t of the round is built
// (mirrored by kernels/bs_sweep.py:join_block_smem).
__host__ __device__ constexpr int join_area(int F, bool raw) {
  return raw ? (F + 6) / 4 * 4 : join_stride(F);
}
__host__ __device__ constexpr int join_buf(int F, bool raw, int round) {
  return round * (join_area(F, raw) + 3) + (F + 3) / 4 * 4 + 4;
}
__host__ __device__ constexpr int join_smem_floats(int F, bool raw,
                                                   int round) {
  return kJoinBufs * join_buf(F, raw, round) +
         (raw ? round * join_stride(F) : 0);
}
// ... and the block's whole, with the sums area at two or three units a
// thread
__host__ __device__ constexpr int join_block_floats(int F, bool raw, int round,
                                                    int kU, int threads) {
  return join_smem_floats(F, raw, round) + (kU > 1 ? kU * 32 * threads : 0);
}

template <int kU, bool kRaw, int kRound>
__global__ void __launch_bounds__(kU > 1 ? kJoinThreadsWide : kJoinThreads, 1)
    join_agg_block_kernel(const int64_t* __restrict__ plan, int nb,
                          int64_t nrows, const float* __restrict__ e,
                          const float* __restrict__ q, int F,
                          float* __restrict__ rtab) {
  extern __shared__ float4 agg_smem4[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kS = join_stride(F);
  const int kB = kS / 4;  // 4-blocks a side of the Gram matrix (even)
  const int units = kB * (kB + 2) / 4;
  const int kA = join_area(F, kRaw);
  const int kBuf = join_buf(F, kRaw, kRound);
  const int nq = (F + 3) / 4;  // float4s of q an entry
  float* const smem = reinterpret_cast<float*>(agg_smem4);
  const int64_t ld = RelLayout(F).ld;
  const int CH = agg_channels(F);
  // this thread's units (row blocks 2p, 2p + 1 over column block bj >= 2p,
  // the tiles (2p, bj) in its sums [0:16], (2p + 1, bj) in [16:32]); a
  // thread without one sums unit 0 and writes nothing.  At one unit a
  // thread the sums stay in acc across a row's rounds; at two or three
  // (F > 172) that many would spill, so a unit's sums are in acc only
  // while it adds a round, and in the block's sums area (after the round
  // buffers; [kU][8][nt] float4s, so that neighbouring threads touch
  // neighbouring words) between rounds
  constexpr bool kSwap = kU > 1;
  int bp[kU], bj[kU];
  float acc[32];
#pragma unroll
  for (int s = 0; s < kU; ++s) {
    int u = tid + nt * s;
    bp[s] = bj[s] = 0;
    if (u < units) {
      int p = 0;
      while (u >= kB - 2 * p) u -= kB - 2 * p++;
      bp[s] = 2 * p;
      bj[s] = 2 * p + u;
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  float4* const sacc = reinterpret_cast<float4*>(
      smem + join_smem_floats(F, kRaw, kRound));
  auto sums_at = [&](int s, int c) { return sacc + (s * 8 + c) * nt + tid; };
  bool fresh = true;  // the next round starts a row
  // a round buffer's parts
  auto xs_of = [&](float* buf) { return buf + kRound * kA; };
  auto sr_of = [&](float* buf) {
    return reinterpret_cast<int*>(buf + kRound * (kA + 1));
  };
  auto es_of = [&](float* buf) { return buf + kRound * (kA + 2); };
  auto qb_of = [&](float* buf) { return buf + kRound * (kA + 3); };
  auto hdr_of = [&](float* buf) {
    return reinterpret_cast<int*>(buf + kRound * (kA + 3) + 4 * nq);
  };

  // warp 0's stream of rounds (as the warp form's, a block a row): read()
  // issues a round's loads and leaves them to land, stage_head() takes
  // them a round later (a select or a test on them here would stall the
  // warp, and the block at its next barrier, for a memory latency)
  AggBuckets bks{plan, nb};
  int64_t g = blockIdx.x;
  int l0 = 0;
  JoinRound rd;
  auto read = [&]() {
    rd.valid = g < nrows;
    if (!rd.valid) return;
    bks.seek(g);
    const int64_t c = g - bks.first;
    const int L = bks.L;
    const int* crow = bks.rows + c * L;
    const float* cx = bks.x + c * L;
    rd.L = L;
    rd.l = l0 + lane;
    rd.r = rd.rl = 0;
    rd.x = 0.f;
    rd.xl = 1.f;
    if (lane < kRound && rd.l < L) {
      rd.r = crow[rd.l];
      rd.x = cx[rd.l];
    }
    if (L > 0) {  // the row's last slot (its pad row) in every round
      rd.rl = crow[L - 1];
      rd.xl = cx[L - 1];
    }
    rd.rho = bks.cols[c];
    l0 += kRound;
    rd.last = l0 >= L;
    if (rd.last) {
      g += gridDim.x;
      l0 = 0;
    }
  };
  // warp 0: the round read last into buffer buf, its gathered entries
  // compacted: row ids, x (0 past them to a multiple of four), e by
  // cp.async (aligned: into the entry's t, with the 1, the zeros and zero
  // entries to a multiple of four), the row's qB0 (cp.async; zeros to a
  // float4) and the header
  auto stage_head = [&](float* buf) {
    int* s_r = sr_of(buf);
    float* xs = xs_of(buf);
    const bool keep = rd.valid && lane < kRound && rd.l < rd.L &&
                      svbfm::PadRow(rd.rl, rd.L, rd.xl == 0.f)
                          .gathers(rd.l, rd.r, rd.x);
    const unsigned m = __ballot_sync(svbfm::kFullMask, keep);
    const int n = __popc(m);
    const int n4 = (n + 3) & ~3;
    if (keep) {
      const int i = __popc(m & ((1u << lane) - 1));
      s_r[i] = rd.r;
      xs[i] = rd.x;
      if constexpr (kRaw) {
        cp_async<4>(es_of(buf) + i, e + rd.r);
      } else {
        float* t = buf + i * kS;
        cp_async<4>(t, e + rd.r);
        t[1] = 1.f;
        t[2] = t[3] = 0.f;
        for (int c = F + 4; c < kS; ++c) t[c] = 0.f;
      }
    }
    if (lane >= n && lane < n4) xs[lane] = 0.f;
    if constexpr (!kRaw) {
      for (int i = n * kS + lane; i < n4 * kS; i += 32) buf[i] = 0.f;
    }
    if (rd.valid) {
      float* qbs = qb_of(buf);
      for (int f = lane; f < F; f += 32)
        cp_async<4>(qbs + f, rtab + rd.rho * ld + f);
      if (lane < 4 * nq - F) qbs[F + lane] = 0.f;
    }
    if (lane == 0) {
      int* hdr = hdr_of(buf);
      hdr[0] = rd.valid ? n : -1;
      hdr[1] = rd.last;
      hdr[2] = static_cast<int>(rd.rho);
      hdr[3] = static_cast<int>(rd.rho >> 32);
    }
  };
  // every thread: its share of the round's q rows by 16-byte copies,
  // word c0 (+ nt, ... where a row has more words than the block threads)
  // of entries k0, k0 + per, ...: aligned, the row's F / 4 words into its
  // t; unaligned, the words that hold the row (a row of F floats at any
  // alignment lies in at most kA / 4 of them) into its raw span (4-byte
  // copies of an unaligned row, a request a float, were the kernel's
  // largest cost at F = 33 on the H100)
  const int nw = kRaw ? kA / 4 : nq;
  const int per = nt >= nw ? nt / nw : 1;
  const int k0 = tid / nw;
  const int c0 = tid - k0 * nw;
  auto stage_q = [&](float* buf) {
    const int* s_r = sr_of(buf);
    const int n = hdr_of(buf)[0];
    if (k0 >= per) return;
    for (int c = c0; c < nw; c += nt) {
#pragma unroll 4
      for (int k = k0; k < n; k += per) {
        const float* row = q + static_cast<int64_t>(s_r[k]) * F;
        if constexpr (kRaw) {
          const uintptr_t a = reinterpret_cast<uintptr_t>(row);
          // the words that hold one of the row's floats, no further
          if (16 * c < static_cast<int>(a & 15) + 4 * F)
            cp_async<16>(buf + k * kA + 4 * c,
                         reinterpret_cast<const float*>(
                             (a & ~uintptr_t{15}) + 16 * c));
        } else {
          cp_async<16>(buf + k * kS + 4 + 4 * c, row + 4 * c);
        }
      }
    }
  };

  if (warp == 0) {
    read();
#pragma unroll
    for (int d = 0; d < kJoinBufs - 1; ++d) {
      stage_head(smem + d * kBuf);
      read();
    }
  }
  cp_async_commit();
  __syncthreads();
#pragma unroll
  for (int d = 0; d < kJoinBufs - 2; ++d) {
    stage_q(smem + d * kBuf);
    cp_async_commit();
  }
  const GridWalk twalk(tid, nt, kRaw ? kB : nq);
  for (int i = 0;; ++i) {
    // round i + kJoinBufs - 1's slots into the buffer summed last, round
    // i + kJoinBufs - 2's q rows; then round i, whose copies were issued
    // rounds ago
    if (warp == 0) {
      stage_head(smem + (i + kJoinBufs - 1) % kJoinBufs * kBuf);
      read();
    }
    stage_q(smem + (i + kJoinBufs - 2) % kJoinBufs * kBuf);
    cp_async_commit();
    cp_async_wait<kJoinBufs - 2>();
    __syncthreads();
    float* const cb = smem + i % kJoinBufs * kBuf;
    const float* xs = xs_of(cb);
    const int n = hdr_of(cb)[0];
    if (n < 0) break;  // past the block's last round
    // the round's t: aligned, qO = q - qB0 in place; unaligned, built in
    // the t area, word c of entry k = (e, 1, 0, 0), qO from its raw span,
    // or zeros (past F + 3, and entries n .. n4 - 1)
    const float4* qb4 = reinterpret_cast<const float4*>(qb_of(cb));
    float* const tt = kRaw ? smem + kJoinBufs * kBuf : cb;
    float4* const t4 = reinterpret_cast<float4*>(tt);
    if constexpr (kRaw) {
      const int* s_r = sr_of(cb);
      const float* es = es_of(cb);
      for (GridWalk w = twalk; w.k < ((n + 3) & ~3); w.next()) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (w.k < n) {
          if (w.c == 0) {
            t.x = es[w.k];
            t.y = 1.f;
          } else if (w.c <= nq) {
            const int f0 = 4 * (w.c - 1);
            // the row's float offset in its first 16-byte word
            const int sh = static_cast<int>(
                (reinterpret_cast<uintptr_t>(
                     q + static_cast<int64_t>(s_r[w.k]) * F) >> 2) & 3);
            const float* src = cb + w.k * kA + sh + f0;
            const float4 b = qb4[w.c - 1];
            // float f0 < F; the word's floats past F (the next row's q)
            // become zeros
            t.x = src[0] - b.x;
            t.y = f0 + 1 < F ? src[1] - b.y : 0.f;
            t.z = f0 + 2 < F ? src[2] - b.z : 0.f;
            t.w = f0 + 3 < F ? src[3] - b.w : 0.f;
          }
        }
        t4[w.k * kB + w.c] = t;
      }
    } else {
      for (GridWalk w = twalk; w.k < n; w.next()) {
        float4 t = t4[w.k * kB + 1 + w.c];
        const float4 b = qb4[w.c];
        t.x -= b.x;
        t.y -= b.y;
        t.z -= b.z;
        t.w -= b.w;
        t4[w.k * kB + 1 + w.c] = t;
      }
    }
    __syncthreads();
    // unit s's sums of the round into a (four entries' loads in flight)
    auto add_round = [&](float (&a)[32], int s) {
      for (int k = 0; k < n; k += 4) {
        const float4* tk = t4 + k * kB;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xk = xs[k + u];
          const float4 a0 = tk[u * kB + bp[s]];
          const float4 a1 = tk[u * kB + bp[s] + 1];
          const float4 b = tk[u * kB + bj[s]];
          const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          const float bx[4] = {b.x * xk, b.y * xk, b.z * xk, b.w * xk};
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              a[4 * ii + jj] = fmaf(av[ii], bx[jj], a[4 * ii + jj]);
          }
        }
      }
    };
    if constexpr (kSwap) {
#pragma unroll
      for (int s = 0; s < kU; ++s) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 v = fresh ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *sums_at(s, c);
          acc[4 * c] = v.x;
          acc[4 * c + 1] = v.y;
          acc[4 * c + 2] = v.z;
          acc[4 * c + 3] = v.w;
        }
        add_round(acc, s);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *sums_at(s, c) = make_float4(acc[4 * c], acc[4 * c + 1],
                                       acc[4 * c + 2], acc[4 * c + 3]);
      }
    } else {
      add_round(acc, 0);
    }
    const int* hdr = hdr_of(cb);
    fresh = hdr[1];
    if (!hdr[1]) {
      __syncthreads();  // the round is summed: buffer i is free for the next
      continue;
    }
    // the row's last round: its CH sums out through the round's first area
    // (unaligned: its raw spans, free since the t area was built, so no
    // thread waits for the others' sums before it stages)
    const int64_t rho = static_cast<int64_t>(
        (static_cast<uint64_t>(static_cast<unsigned>(hdr[3])) << 32) |
        static_cast<unsigned>(hdr[2]));
    float* const out = rtab + rho * ld + F;  // streaming: never read back
    // channel o sits at cb[o + mis - w0] in the window from w0, so that the
    // area's float4s are the row's aligned 16-byte words
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
    const int win = kRound * kA;
    float* const base = out - mis;
    for (int w0 = 0; w0 < CH + mis; w0 += win) {
      // aligned, the round summed; then the last window out
      if (!kRaw || w0 > 0) __syncthreads();
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        if (tid + nt * s < units) {
          if constexpr (kSwap) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float4 v = *sums_at(s, c);
              acc[4 * c] = v.x;
              acc[4 * c + 1] = v.y;
              acc[4 * c + 2] = v.z;
              acc[4 * c + 3] = v.w;
            }
          }
          stage_cells(acc, 0, bp[s], bj[s], F, mis - w0, win, cb);
          if (bp[s] < bj[s])
            stage_cells(acc, 16, bp[s] + 1, bj[s], F, mis - w0, win, cb);
        }
      }
      // the window staged; and every thread's sums of the round done, so
      // that warp 0 may stage round i + kJoinBufs into buffer i
      __syncthreads();
      const int m = min(win, CH + mis - w0);
      for (int k4 = tid; 4 * k4 < m; k4 += nt) {
        const int o = w0 + 4 * k4 - mis;  // the channel of cb[4 k4]
        if (o >= 0 && o + 4 <= CH) {
          __stcs(reinterpret_cast<float4*>(base + w0) + k4,
                 reinterpret_cast<const float4*>(cb)[k4]);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (o + v >= 0 && o + v < CH) __stcs(out + o + v, cb[4 * k4 + v]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    // aligned, the window just stored from is round i + kJoinBufs's t
    if constexpr (!kRaw) __syncthreads();
  }
  cp_async_wait_all();
}

// X10a's block form at F: (kU units a thread, threads a block), kU the
// fewest of 1, 2, 3 with which the kB (kB + 2) / 4 units fit a block; 0
// threads past the widest (mirrored by kernels/bs_sweep.py:
// join_block_plan).
struct JoinBlockPlan {
  int kU, threads;
};
static JoinBlockPlan join_block_plan(int F) {
  const int kB = join_stride(F) / 4;
  const int units = kB * (kB + 2) / 4;
  const int kU = units <= kJoinThreads           ? 1
                 : units <= 2 * kJoinThreadsWide ? 2
                                                 : 3;
  const int threads = ((units + kU - 1) / kU + 31) / 32 * 32;
  return {kU, threads <= (kU > 1 ? kJoinThreadsWide : kJoinThreads) ? threads
                                                                    : 0};
}

// ---- X10b -------------------------------------------------------------------

// X10b's forms (chosen by kernels/bs_sweep.py:draw_form from F and L):
// F <= 1: G lanes a column (L <= 32), or a block per (column, split) with
// the threads over the split's entries; F >= 2: a warp a column (L <= 32),
// or a block per (column, split) over staged tiles of relation rows, whole
// (kFormTiles) or, where two tiles of whole rows do not fit the block,
// without wcc, which the owner threads then read from L2 (kFormTilesL2).
constexpr int kFormGroup = 0, kFormBlock = 1, kFormWarp = 2, kFormTiles = 3,
              kFormTilesL2 = 4;
constexpr int kDrawThreads = 256;
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Sums a relation column owns: she [Fo], sh2 [Fo], then the packed M.
__host__ __device__ inline int draw_outputs(int F) {
  const int Fo = F > 1 ? F : 1;
  return 2 * Fo + (F > 1 ? F * (F - 1) / 2 : 0);
}

// Block s's share [b, e) of a column's n real entries split S ways: every
// share is at least one entry when S <= n, and the shares cover [0, n)
// (mirrored by kernels/bs_sweep.py:split_bounds).
__device__ __forceinline__ void split_range(int n, int S, int s, int& b,
                                            int& e) {
  b = static_cast<int>(static_cast<int64_t>(s) * n / S);
  e = static_cast<int>(static_cast<int64_t>(s + 1) * n / S);
}

// n floats of a relation row into shared memory by `lanes` lanes of a
// warp, vec floats a copy (4, 2 or 1: what n and the row's address allow).
template <bool kL1 = false>
__device__ __forceinline__ void row_copy_async(float* dst, const float* src,
                                               int n, int vec, int lane,
                                               int lanes) {
  if (vec == 4) {
    for (int k = lane; k < n / 4; k += lanes)
      cp_async<16, kL1>(dst + 4 * k, src + 4 * k);
  } else if (vec == 2) {
    for (int k = lane; k < n / 2; k += lanes)
      cp_async<8>(dst + 2 * k, src + 2 * k);
  } else {
    for (int k = lane; k < n; k += lanes) cp_async<4>(dst + k, src + k);
  }
}

// One entry's terms of the three kinds of sums (mcmc_bs.py:392-412), with
// h_f = x (qB_f - x v_f) from the entry's relation row:
__device__ __forceinline__ float she_term(float h, float xv, float we,
                                          float weq) {
  return h * we + xv * weq;
}

__device__ __forceinline__ float sh2_term(float h, float xv, float wn,
                                          float wc, float wcc) {
  return h * h * wn + 2.f * wc * xv * h + xv * xv * wcc;
}

__device__ __forceinline__ float m_term(float hf, float hg, float xv,
                                        float wn, float wcf, float wcg,
                                        float wcc) {
  return hf * hg * wn + hf * xv * wcg + xv * hg * wcf + xv * xv * wcc;
}

// The pair (f, g) of the first M sum among o = first, first + step, ...
__device__ __forceinline__ void first_pair(int first, int step, int F,
                                           int nout, int& f, int& g) {
  int o = first;
  if (o < 2 * F) o += (2 * F - o + step - 1) / step * step;
  f = 0;
  g = 1;
  if (o < nout) {
    const int fg = svbfm::pair_at(o - 2 * F, F);
    f = fg >> 16;
    g = fg & 0xffff;
  }
}

// Adds the entries l < nl of a staged set of relation rows (row l at
// rowbuf + l ldr; wn at wn_s of a row; xs[l] its x, 0: skipped; wcc from
// the staged row or, kWccL2, from rtab at row rs[l]) into the sums
// o = first, first + step, ... < nout of acc; (f, g) the pair of the first
// M sum.  The order of the additions is fixed: the result is the same bits
// on every launch.
template <bool kWccL2>
__device__ __forceinline__ void add_rows(
    float* acc, int first, int step, int nout, int f, int g,
    const float* rowbuf, int ldr, int wn_s, const float* xs, const int* rs,
    int nl, const float* vc, const RelLayout& lay,
    const float* __restrict__ rtab) {
  const int F = lay.F;
  for (int o = first; o < nout; o += step) {
    float s = 0.f;
    if (o < 2 * F) {
      const int fo = o < F ? o : o - F;
      const float vf = vc[fo];
      const int off = lay.wcc_at(fo, fo);
      for (int l = 0; l < nl; ++l) {
        const float xv = xs[l];
        if (xv == 0.f) continue;
        const float* row = rowbuf + l * ldr;
        const float h = xv * (row[fo] - xv * vf);
        if (o < F) {
          s += she_term(h, xv, row[lay.we], row[lay.weq + fo]);
        } else {
          const float wcc =
              kWccL2 ? rtab[static_cast<int64_t>(rs[l]) * lay.ld + off]
                     : row[off];
          s += sh2_term(h, xv, row[wn_s], row[lay.wc + fo], wcc);
        }
      }
    } else {
      const float vf = vc[f], vg = vc[g];
      const int off = lay.wcc_at(f, g);
      for (int l = 0; l < nl; ++l) {
        const float xv = xs[l];
        if (xv == 0.f) continue;
        const float* row = rowbuf + l * ldr;
        const float wcc =
            kWccL2 ? rtab[static_cast<int64_t>(rs[l]) * lay.ld + off]
                   : row[off];
        s += m_term(xv * (row[f] - xv * vf), xv * (row[g] - xv * vg), xv,
                    row[wn_s], row[lay.wc + f], row[lay.wc + g], wcc);
      }
      svbfm::pair_step(f, g, step, F);
    }
    acc[o] += s;
  }
}

// The column's pre-bin v and priors (mu, lambda, z) into shared memory, by
// the threads first, first + step, ...
__device__ __forceinline__ void load_column(
    int first, int step, int F, int64_t col, int g_c,
    const float* __restrict__ ptab, const float* __restrict__ mu,
    const float* __restrict__ lam, const float* __restrict__ z, int64_t Dr,
    float* vc, float* prior) {
  for (int f = first; f < F; f += step) {
    vc[f] = ptab[col * 2 * F + f];
    prior[f] = mu[g_c * F + f];
    prior[F + f] = lam[g_c * F + f];
    prior[2 * F + f] = z != nullptr ? z[f * Dr + col] : 0.f;
  }
}

// Adds the warp's NaN/Inf draws to the counters.
__device__ __forceinline__ void count_bad(int nan_c, int inf_c,
                                          int* __restrict__ nans) {
  nan_c = __reduce_add_sync(svbfm::kFullMask, nan_c);
  inf_c = __reduce_add_sync(svbfm::kFullMask, inf_c);
  if ((threadIdx.x & 31) == 0) {
    if (nan_c) atomicAdd(&nans[0], nan_c);
    if (inf_c) atomicAdd(&nans[1], inf_c);
  }
}

// Floats of a column's slice in the warp form at F >= 2 with E rows a
// round: sums, rows, v and priors, the round's x and row ids (mirrored by
// kernels/bs_sweep.py:warp_slice).
__host__ __device__ inline int warp_slice(int F, int E) {
  return round4(round4(draw_outputs(F)) + E * round4(RelLayout(F).ld) +
                4 * F + 2 * E);
}

// E, the rows a round of the warp form with G lanes a column: one at G = 8
// (four slices a warp), else as many as 1,536 floats hold, one to four
// (mirrored by kernels/bs_sweep.py:warp_rows).
__host__ __device__ inline int warp_rows(int F, int G) {
  const int n = 1536 / round4(RelLayout(F).ld);
  return G < 32 || n < 1 ? 1 : (n > 4 ? 4 : n);
}

// X10b, F >= 2, a bucket of L <= kW slots: kW lanes a column (a warp, or
// at kW = 8 four columns a warp), a slice of shared memory a column, no
// block barrier.  The lanes hold the column's slots; each round stages
// the next E real entries' relation rows (16-byte copies where the layout
// allows), the lanes add them into the sums they own, and the group draws
// (svbfm::group_sequential_draws).  A warp's groups run the same number
// of rounds and steps, so that every lane takes part in each shuffle; a
// group past the last column works on the last one and writes nothing.
template <int kW, int kSlots>
__global__ void __launch_bounds__(kDrawThreads, kSlots * kW <= 32 ? 4 : 1)
    rel_draw_warp_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int E, int vec, const int* __restrict__ cols,
    const int* __restrict__ group, const float* __restrict__ rtab, int F,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int64_t Dr, int* __restrict__ nans) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (kW - 1);        // the lane in its column's group
  const int slot = threadIdx.x / kW;     // the column's slice
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kW);
  if (c0 + (threadIdx.x & ~31) / kW >= C) return;  // the whole warp leaves
  const bool live = c0 + slot < C;
  const int64_t c = live ? c0 + slot : C - 1;
  const RelLayout lay(F);
  const int nout = draw_outputs(F);
  const int ldr = round4(lay.ld);
  float* acc = smem + slot * warp_slice(F, E);  // [nout]
  float* rowbuf = acc + round4(nout);           // [E, ldr]
  float* vc = rowbuf + E * ldr;                 // [F]
  float* prior = vc + F;                        // [3, F]: mu, lambda, z
  float* xs = prior + 3 * F;                    // [E]
  int* rs = reinterpret_cast<int*>(xs + E);     // [E]
  const int64_t col = cols[c];
  const int g_c = group[c];
  const float xl = gl < L ? x[c * L + gl] : 0.f;
  const int rl = gl < L ? rows[c * L + gl] : 0;
  const unsigned gmask = kW == 32 ? svbfm::kFullMask : (1u << kW) - 1u;
  const unsigned real =
      (__ballot_sync(svbfm::kFullMask, xl != 0.f) >> (lane & ~(kW - 1))) &
      gmask;
  const int nreal = __popc(real);
  const int rank = __popc(real & ((1u << gl) - 1u));
  const int rounds =
      __reduce_max_sync(svbfm::kFullMask, (nreal + E - 1) / E);
  // the real entries e0 .. e0 + E - 1: their x and row ids, then their rows
  auto stage = [&](int e0) {
    if (xl != 0.f && rank >= e0 && rank < e0 + E) {
      xs[rank - e0] = xl;
      rs[rank - e0] = rl;
    }
    __syncwarp();
    for (int e = 0; e < min(E, nreal - e0); ++e)
      row_copy_async(rowbuf + e * ldr,
                     rtab + static_cast<int64_t>(rs[e]) * lay.ld, lay.ld, vec,
                     gl, kW);
  };
  stage(0);  // in flight while the column's v and priors load
  load_column(gl, kW, F, col, g_c, ptab, mu, lam, z, Dr, vc, prior);
  for (int o = gl; o < nout; o += kW) acc[o] = 0.f;
  int f0, g0;
  first_pair(gl, kW, F, nout, f0, g0);
  for (int r = 0; r < rounds; ++r) {
    cp_async_wait_all();
    __syncwarp();
    add_rows<false>(acc, gl, kW, nout, f0, g0, rowbuf, ldr, lay.wn, xs, rs,
                    max(0, min(E, nreal - r * E)), vc, lay, rtab);
    __syncwarp();
    if (r + 1 < rounds) stage((r + 1) * E);
  }
  __syncwarp();  // the sums, v and priors, for a column with no real entry
  int nan_c = 0, inf_c = 0;
  svbfm::group_sequential_draws<kW, kSlots>(
      acc, F, vc, prior, *alpha_p, z != nullptr, live, v_t + col * F,
      ptab + col * 2 * F + F, nan_c, inf_c);
  count_bad(live ? nan_c : 0, live ? inf_c : 0, nans);
}

// Bytes of shared memory of the tiled form: two tiles of T staged rows
// (whole, or without wcc), the sums, three slots of the tiles' x and row
// ids, v and priors, one flag (mirrored by kernels/bs_sweep.py:tiles_smem).
__host__ __device__ inline int tiles_smem(int F, int T, bool whole) {
  const RelLayout lay(F);
  const int lds = whole ? lay.ld : lay.wcc + 1;
  return static_cast<int>(sizeof(float)) *
         (2 * T * round4(lds) + round4(draw_outputs(F)) + 6 * T + 4 * F + 1);
}

// X10b, F >= 2, a block per (column, split) over the split's real entries
// in tiles of T relation rows, double-buffered: while the block adds tile
// t from shared memory, the cp.async copies of tile t + 1's rows and of
// tile t + 2's x and row ids are in flight; one barrier a tile.  Each
// thread owns the sums o = tid, tid + 256, ...  With S > 1 the last block
// of the column to finish adds the S partials in a fixed order; warp 0
// draws.  kWccL2: the rows are staged without wcc (qB | we | weq | wc,
// then wn), and the owners read wcc from rtab.
template <bool kWccL2, int kSlots>
__global__ void rel_draw_tiles_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L, int S,
    int T, int vec, const int* __restrict__ nreal,
    const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ rtab, int F, float* __restrict__ ptab,
    float* __restrict__ v_t, const float* __restrict__ mu,
    const float* __restrict__ lam, const float* __restrict__ alpha_p,
    const float* __restrict__ z, int64_t Dr, int* __restrict__ nans,
    float* __restrict__ part, int* __restrict__ done) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int c = blockIdx.x;
  const int s_i = blockIdx.y;
  const RelLayout lay(F);
  const int nout = draw_outputs(F);
  const int lds = kWccL2 ? lay.wcc + 1 : lay.ld;  // staged floats a row
  const int wn_s = kWccL2 ? lay.wcc : lay.wn;     // wn in a staged row
  const int ldr = round4(lds);
  float* rowbuf = smem;                                  // [2, T, ldr]
  float* acc = rowbuf + 2 * T * ldr;                     // [nout]
  float* xs = acc + round4(nout);                        // [3, T]
  int* rs = reinterpret_cast<int*>(xs + 3 * T);          // [3, T]
  float* vc = reinterpret_cast<float*>(rs + 3 * T);      // [F]
  float* prior = vc + F;                                 // [3, F]
  float* last = prior + 3 * F;                           // [1]
  const int64_t col = cols[c];
  int b, e;
  split_range(nreal[c], S, s_i, b, e);
  const int n = e - b;
  const int ntiles = (n + T - 1) / T;
  const int* crow = rows + static_cast<int64_t>(c) * L + b;
  const float* cx = x + static_cast<int64_t>(c) * L + b;
  int f0, g0;
  first_pair(tid, nt, F, nout, f0, g0);

  // tile t's x and row ids into slot t % 3 (zeros past the split)
  auto stage_ids = [&](int t) {
    const int l = t * T + tid;
    float* xd = xs + (t % 3) * T + tid;
    int* rd = rs + (t % 3) * T + tid;
    if (tid >= T) return;
    if (l < n) {
      cp_async<4>(xd, cx + l);
      cp_async<4>(rd, crow + l);
    } else {
      *xd = 0.f;
      *rd = 0;
    }
  };
  // tile t's relation rows into buffer t % 2, a warp a row
  auto stage_rows = [&](int t) {
    const int nl = min(T, n - t * T);
    const int* rt = rs + (t % 3) * T;
    float* buf = rowbuf + (t & 1) * T * ldr;
    for (int l = wid; l < nl; l += nw) {
      const float* src = rtab + static_cast<int64_t>(rt[l]) * lay.ld;
      float* dst = buf + l * ldr;
      if (kWccL2) {
        row_copy_async(dst, src, lay.wcc, 1, lane, 32);
        if (lane == 0) cp_async<4>(dst + lay.wcc, src + lay.wn);
      } else {
        row_copy_async(dst, src, lay.ld, vec, lane, 32);
      }
    }
  };

  stage_ids(0);
  cp_async_commit();
  load_column(tid, nt, F, col, group[c], ptab, mu, lam, z, Dr, vc, prior);
  for (int o = tid; o < nout; o += nt) acc[o] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (ntiles > 0) {
    stage_rows(0);
    stage_ids(1);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's buffers are free
    if (t + 1 < ntiles) {
      stage_rows(t + 1);
      stage_ids(t + 2);
      cp_async_commit();
    }
    add_rows<kWccL2>(acc, tid, nt, nout, f0, g0, rowbuf + (t & 1) * T * ldr,
                     ldr, wn_s, xs + (t % 3) * T, rs + (t % 3) * T,
                     min(T, n - t * T), vc, lay, rtab);
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
#pragma unroll 8
      for (int k = 0; k < S; ++k) t += __ldcg(all + k * nout + o);
      acc[o] = t;
    }
    if (tid == 0) done[c] = 0;  // ready for the next launch
  }
  __syncthreads();  // the sums are complete
  if (tid >= 32) return;
  int nan_c = 0, inf_c = 0;
  svbfm::warp_sequential_draws<kSlots>(
      acc, F, vc, prior, *alpha_p, z != nullptr, v_t + col * F,
      ptab + col * 2 * F + F, nan_c, inf_c);
  count_bad(nan_c, inf_c, nans);
}

// One entry's she and sh2 terms at F <= 1: kW the w sweep (rtab [R, 2] =
// we | wn, h = x), else F = 1 (qB | we | weq | wc | wcc | wn, 8-byte
// aligned rows); the terms of the F = 1 sums (mcmc_bs.py:781-787) and the
// w sums (:657-660).
template <bool kW>
__device__ __forceinline__ void entry_sums1(const float* __restrict__ g,
                                            float xv, float v_c, float& she,
                                            float& sh2) {
  const float2* g2 = reinterpret_cast<const float2*>(g);
  if constexpr (kW) {
    const float2 p = g2[0];
    she += xv * p.x;
    sh2 += xv * xv * p.y;
  } else {
    const float2 a = g2[0], b = g2[1], d = g2[2];
    const float h = xv * (a.x - xv * v_c);
    she += she_term(h, xv, a.y, b.x);
    sh2 += sh2_term(h, xv, d.y, b.y, d.x);
  }
}

// The one draw of a column at F <= 1: v_t [Dr] (w or v), ptab [Dr, 2].
__device__ __forceinline__ void draw_one_column(
    float she, float sh2, float v_c, int64_t col, int g_c,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int* __restrict__ nans) {
  int nan_c = 0, inf_c = 0;
  const float nv = svbfm::draw_one(she, sh2, v_c, mu[g_c], lam[g_c],
                                   *alpha_p, z != nullptr,
                                   z != nullptr ? z[col] : 0.f, nan_c, inf_c);
  v_t[col] = nv;
  ptab[2 * col + 1] = v_c - nv;
  if (nan_c) atomicAdd(&nans[0], nan_c);
  if (inf_c) atomicAdd(&nans[1], inf_c);
}

// X10b, F <= 1, a bucket of L <= 32 slots: G lanes a column (G a power of
// two <= 32, so a column's lanes sit in one warp), many columns a block;
// the lanes read the column's slots side by side, gather the real ones'
// rows and end with a butterfly over the G lanes; lane 0 draws.  No lane
// leaves before the shuffles.
template <bool kW>
__global__ void rel_draw_group_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int C, int L,
    int G, const int* __restrict__ cols, const int* __restrict__ group,
    const float* __restrict__ rtab, float* __restrict__ ptab,
    float* __restrict__ v_t, const float* __restrict__ mu,
    const float* __restrict__ lam, const float* __restrict__ alpha_p,
    const float* __restrict__ z, int* __restrict__ nans) {
  constexpr int ld = kW ? 2 : 6;
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & (G - 1);
  const bool live = c < C;
  float she = 0.f, sh2 = 0.f, v_c = 0.f;
  int64_t col = 0;
  if (live) {
    col = cols[c];
    v_c = ptab[2 * col];
    for (int l = lane; l < L; l += G) {
      const float xv = x[c * L + l];
      const int64_t r = rows[c * L + l];
      if (xv == 0.f) continue;  // a padding slot gathers nothing
      entry_sums1<kW>(rtab + r * ld, xv, v_c, she, sh2);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    she += __shfl_xor_sync(svbfm::kFullMask, she, o);
    sh2 += __shfl_xor_sync(svbfm::kFullMask, sh2, o);
  }
  if (live && lane == 0)
    draw_one_column(she, sh2, v_c, col, group[c], ptab, v_t, mu, lam,
                    alpha_p, z, nans);
}

// X10b, F <= 1, a bucket of L > 32 slots: a block per (column, split), the
// threads over the split's real entries, butterflies over the lanes and
// the warps; with S > 1 the last block of the column adds the S partials,
// its lanes over them and a butterfly (a fixed order); lane 0 draws.
template <bool kW>
__global__ void rel_draw_block_kernel(
    const int* __restrict__ rows, const float* __restrict__ x, int L, int S,
    const int* __restrict__ nreal, const int* __restrict__ cols,
    const int* __restrict__ group, const float* __restrict__ rtab,
    float* __restrict__ ptab, float* __restrict__ v_t,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ alpha_p, const float* __restrict__ z,
    int* __restrict__ nans, float* __restrict__ part,
    int* __restrict__ done) {
  constexpr int ld = kW ? 2 : 6;
  __shared__ float red[2 * kDrawWarps];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int s_i = blockIdx.y;
  const int64_t col = cols[c];
  const float v_c = ptab[2 * col];
  int b, e;
  split_range(nreal[c], S, s_i, b, e);
  const int* crow = rows + static_cast<int64_t>(c) * L;
  const float* cx = x + static_cast<int64_t>(c) * L;
  float she = 0.f, sh2 = 0.f;
  for (int l = b + tid; l < e; l += kDrawThreads) {
    const float xv = cx[l];
    const int64_t r = crow[l];
    if (xv == 0.f) continue;
    entry_sums1<kW>(rtab + r * ld, xv, v_c, she, sh2);
  }
  she = svbfm::warp_sum(she);
  sh2 = svbfm::warp_sum(sh2);
  const int lane = tid & 31;
  if (lane == 0) {
    red[tid >> 5] = she;
    red[kDrawWarps + (tid >> 5)] = sh2;
  }
  __syncthreads();
  if (tid >= 32) return;  // warp 0 goes on
  she = lane < kDrawWarps ? red[lane] : 0.f;
  sh2 = lane < kDrawWarps ? red[kDrawWarps + lane] : 0.f;
  she = svbfm::warp_sum(she);
  sh2 = svbfm::warp_sum(sh2);
  if (S > 1) {  // the last block of the column adds the partials
    float* mine = part + (static_cast<int64_t>(c) * S + s_i) * 2;
    if (lane == 0) {
      mine[0] = she;
      mine[1] = sh2;
      __threadfence();
      last = atomicAdd(&done[c], 1) == S - 1;
    }
    __syncwarp();
    if (!last) return;  // the whole warp leaves together
    __threadfence();
    // the lanes over the partials, then a butterfly: a fixed order
    const float* all = part + static_cast<int64_t>(c) * S * 2;
    she = 0.f;
    sh2 = 0.f;
    for (int k = lane; k < S; k += 32) {
      she += __ldcg(all + 2 * k);
      sh2 += __ldcg(all + 2 * k + 1);
    }
    she = svbfm::warp_sum(she);
    sh2 = svbfm::warp_sum(sh2);
    if (lane == 0) done[c] = 0;  // ready for the next launch
  }
  if (lane == 0)
    draw_one_column(she, sh2, v_c, col, group[c], ptab, v_t, mu, lam,
                    alpha_p, z, nans);
}
// ---- X10c -------------------------------------------------------------------

// X10c's forms, a function of F (mirrored by kernels/bs_sweep.py:
// patch_plan): F <= 1 a thread a relation row; 2 <= F <= 32 G lanes a row,
// G the next power of two >= F, 32 / G rows a warp; F > 32 a block of
// round32(F) threads a row.
constexpr int kPatchThreads = 256;  // the thread and lanes forms' blocks
constexpr int kPatchPos = 2;        // positions staged at once

__host__ __device__ inline int patch_lanes(int F) {
  int G = 1;
  while (G < F) G *= 2;
  return G;
}

// Floats of a row's slice of shared memory in the lanes and block forms:
// the row, then kPatchPos ptab rows, each v_old and dv at 16-byte
// boundaries (mirrored by kernels/bs_sweep.py:patch_slice).
__host__ __device__ inline int patch_slice(int F) {
  return round4(RelLayout(F).ld) + kPatchPos * 2 * round4(F);
}

template <bool kBlock>
__device__ __forceinline__ void group_sync() {
  if constexpr (kBlock) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// a and b summed over a row's G lanes (a power of two <= 32; every lane of
// the warp calls) or, kBlock, over the block through red [2 warps] of
// shared memory, its warps' partials in a fixed order: every thread gets
// the same totals, the same bits on every launch.
template <bool kBlock>
__device__ __forceinline__ void group_sums(float& a, float& b, int G,
                                           float* red) {
  if constexpr (!kBlock) {
    for (int o = G >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(svbfm::kFullMask, a, o);
      b += __shfl_xor_sync(svbfm::kFullMask, b, o);
    }
  } else {
    a = svbfm::warp_sum(a);
    b = svbfm::warp_sum(b);
    const int nw = blockDim.x >> 5, w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[w] = a;
      red[nw + w] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
    for (int i = 0; i < nw; ++i) {
      a += red[i];
      b += red[nw + i];
    }
    __syncthreads();  // red is free for the next sums
  }
}

// The ids and x of up to kPatchPos positions k0 .. k0 + nk - 1 of a
// relation row (rid, rx: its row of rids, rvals), into registers.
struct PatchIds {
  int id[kPatchPos];
  float x[kPatchPos];
};

__device__ __forceinline__ void patch_ids(const int* __restrict__ rid,
                                          const float* __restrict__ rx,
                                          const int* __restrict__ pos, int k0,
                                          int nk, PatchIds& p) {
#pragma unroll
  for (int k = 0; k < kPatchPos; ++k) {
    p.id[k] = 0;
    p.x[k] = 0.f;
    if (k < nk) {
      const int q = pos[k0 + k];
      p.id[k] = rid[q];
      p.x[k] = rx[q];
    }
  }
}

// Their ptab rows (v_old | dv, 2F floats each) into spt [kPatchPos, 2,
// F4], F4 = round4(F), by the group's G threads: v_old and dv each at a
// 16-byte boundary, copied pvec floats at a time through L1 (a slot bin's
// rows all read the same two or so ptab rows).
__device__ __forceinline__ void patch_stage_ptab(
    float* spt, int F4, const float* __restrict__ ptab, int F,
    const PatchIds& p, int nk, int pvec, int gl, int G) {
#pragma unroll
  for (int k = 0; k < kPatchPos; ++k) {
    if (k < nk) {
      const float* src = ptab + static_cast<int64_t>(p.id[k]) * 2 * F;
      row_copy_async<true>(spt + 2 * k * F4, src, F, pvec, gl, G);
      row_copy_async<true>(spt + (2 * k + 1) * F4, src + F, F, pvec, gl, G);
    }
  }
}

// m_f = sum_g dv_g wcc_gf for lane f from the staged row b (wcc at
// b[wcc]) and dv [F] at a 16-byte boundary: lane f walks column f of the
// packed triangle while g < f (wcc_gf at cb(g) + f, cb(g) = wcc + g(2F -
// g + 1)/2 - g; neighbouring lanes on neighbouring words), then its row
// f (wcc_fg at cr + g); four g a step (dv by one 16-byte load), four sums
// added in a fixed order.  kF > 0: F is kF, the walk unrolled whole.
template <int kF>
__device__ __forceinline__ float patch_matvec(const float* b, int wcc,
                                              const float* dv, int F, int f) {
  if constexpr (kF > 0) {
    // F known at compile time: every offset below but f's is a constant,
    // so each g is a compare, a load and an add
    const float* col = b + wcc + f;                         // + cb(g)
    const float* row = b + wcc + f * (2 * kF - f + 1) / 2 - f;  // + g
    float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int g4 = 0; g4 < kF; g4 += 4) {
      float d[4];
      if (g4 + 4 <= kF) {
        const float4 t = *reinterpret_cast<const float4*>(dv + g4);
        d[0] = t.x;
        d[1] = t.y;
        d[2] = t.z;
        d[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = g4 + j < kF ? dv[g4 + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = g4 + j;
        if (g < kF)
          m[j] += d[j] * (g < f ? col[g * (2 * kF - g + 1) / 2 - g] : row[g]);
      }
    }
    return (m[0] + m[1]) + (m[2] + m[3]);
  }
  const int cr = wcc + f * (2 * F - f + 1) / 2 - f;
  int cb = wcc;
  float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
  int g = 0;
  for (; g + 4 <= F; g += 4) {
    const float4 d = *reinterpret_cast<const float4*>(dv + g);
    const int c1 = cb + F - g - 1, c2 = c1 + F - g - 2, c3 = c2 + F - g - 3;
    m0 += d.x * b[g < f ? cb + f : cr + g];
    m1 += d.y * b[g + 1 < f ? c1 + f : cr + g + 1];
    m2 += d.z * b[g + 2 < f ? c2 + f : cr + g + 2];
    m3 += d.w * b[g + 3 < f ? c3 + f : cr + g + 3];
    cb = c3 + F - g - 4;
  }
  for (; g < F; ++g) {
    m0 += dv[g] * b[g < f ? cb + f : cr + g];
    cb += F - g - 1;
  }
  return (m0 + m1) + (m2 + m3);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// X10c at F >= 2 (mcmc_bs.py:442-453): G lanes a relation row (kBlock: the
// block's threads), lane f owning factor f; the lanes form is built for
// each F it takes (kF = F), the block form takes F at run time (kF = 0).  Each group walks its rows
// (one at kBlock; in the lanes form rows gridDim.x * rows-a-block apart,
// the grid the blocks the card holds at once) through two slices of
// shared memory, in a pipeline: while it works on row i, row i + 1's
// copies are in flight (the row whole, 16-byte cp.async where ld and the
// base allow, and its positions' ptab rows v_old | dv, their ids read a
// row earlier) and row i + 2's position ids and x are on their way to
// registers.  A row's work: position by position in order, s1 and t by a
// butterfly over the group, m_f = sum_g dv_g wcc_gf from the staged
// triangle (patch_matvec), and lane f's qB, weq and dy updated in
// registers; only qB, we, weq and dy are written.  Positions past the
// first kPatchPos are staged in turn.  Every lane of a warp takes each
// row (a group past the last row works on the last one and writes
// nothing), so the shuffles see the whole warp.  No row is skipped where
// its dv is 0: 0 inf gives the twin's NaN.
// At most 64 registers a thread: four blocks of the lanes form an SM
// (built for its F, the form takes ~80 otherwise, and three blocks leave
// too few rows in flight: 0.054 against 0.050 ms at F = 20 on an NVIDIA
// H100 80GB HBM3 at 700 W).  Lanes F .. G - 1 idle through the sums, the
// matvec and the writes (12 of 32 at F = 20): the matvec's F^2 products
// spread evenly over all G lanes instead (12 or 13 a lane at F = 20, each
// lane's partials for at most two factors folded by shuffles, F at run
// time) took 0.1056-0.1117 ms on the same card, against 0.0502-0.0573 for
// this form: a warp issues the products of its busiest lane, and the
// split's per-lane bounds and offsets cost more than the idle lanes.
template <bool kBlock, int kF>
__global__ void __launch_bounds__(kPatchThreads, 4)
    rel_patch_group_kernel(const int* __restrict__ rids,
                           const float* __restrict__ rvals, int64_t R,
                           int Pr, const int* __restrict__ pos, int npos,
                           const float* __restrict__ ptab, int F_arg, int G,
                           int vec, int pvec, float* __restrict__ rtab,
                           float* __restrict__ dy) {
  extern __shared__ __align__(16) float smem[];
  const int F = kF > 0 ? kF : F_arg;
  const RelLayout lay(F);
  const int gl = kBlock ? threadIdx.x : threadIdx.x & (G - 1);
  const int slot = kBlock ? 0 : threadIdx.x / G;
  const int per = kBlock ? 1 : blockDim.x / G;  // rows a block a round
  const int nr = static_cast<int>(R);            // < 2^31 (the launch)
  const int stride = gridDim.x * per;
  // the warp's first row and the group's
  const int w0 = blockIdx.x * per + (kBlock ? 0 : (threadIdx.x & ~31) / G);
  const int g0 = blockIdx.x * per + slot;
  const int slice = patch_slice(F);
  const int ldr = round4(lay.ld);
  const int F4 = round4(F);
  // the group's slices (two, one at kBlock: a block takes one row), each a
  // row and its positions' ptab rows; then, at kBlock, the sums' partials
  float* sbuf = smem + (kBlock ? 0 : 2 * slot * slice);
  float* red = smem + (kBlock ? slice : 2 * per * slice);
  const int f = gl;
  const bool own = f < F;
  const int nk0 = min(kPatchPos, npos);
  // a row past R: the last row
  auto clamp = [&](int r) -> int64_t { return r < nr ? r : nr - 1; };
  // a row's first positions' ids and x
  auto row_ids = [&](int r, PatchIds& ids) {
    const int64_t rc = clamp(r);
    patch_ids(rids + rc * Pr, rvals + rc * Pr, pos, 0, nk0, ids);
  };
  // a row's copies into slice b: the row and its positions' ptab rows
  auto stage = [&](int r, float* b, const PatchIds& ids) {
    row_copy_async(b, rtab + clamp(r) * lay.ld, lay.ld, vec, gl, G);
    patch_stage_ptab(b + ldr, F4, ptab, F, ids, nk0, pvec, gl, G);
    cp_async_commit();
  };

  PatchIds ids, next;  // this row's, the next row's
  row_ids(g0, ids);
  stage(g0, sbuf, ids);
  row_ids(g0 + stride, next);
  float xs[kPatchPos];
#pragma unroll
  for (int k = 0; k < kPatchPos; ++k) xs[k] = ids.x[k];
  float dyf = own ? dy[clamp(g0) * F + f] : 0.f;
  int cur = 0;
  for (int w = w0, rho = g0; w < nr; w += stride, rho += stride) {
    float* b = sbuf + (kBlock ? 0 : cur * slice);
    float* nb = sbuf + (kBlock ? 0 : (cur ^ 1) * slice);
    const bool more = w < nr - stride;  // the same in every lane of a warp
    float ndy = 0.f;
    group_sync<kBlock>();  // the group is done with nb's last row
    if (more) {
      stage(rho + stride, nb, next);
      ndy = own ? dy[clamp(rho + stride) * F + f] : 0.f;
      row_ids(rho + stride < nr - stride ? rho + 2 * stride : nr - 1,
              ids);  // the row after: in by its turn
      cp_async_wait_group<1>();        // this row's copies
    } else {
      cp_async_wait_group<0>();
    }
    group_sync<kBlock>();
    float qb = 0.f, weq = 0.f, wc = 0.f;
    if (own) {
      qb = b[f];
      weq = b[lay.weq + f];
      wc = b[lay.wc + f];
    }
    float we = b[lay.we];
    const float wn = b[lay.wn];
    for (int k0 = 0; k0 < npos; k0 += kPatchPos) {
      const int nk = min(kPatchPos, npos - k0);
      if (k0 > 0) {  // the next chunk of positions, staged in turn
        PatchIds more_ids;
        const int64_t rc = clamp(rho);
        patch_ids(rids + rc * Pr, rvals + rc * Pr, pos, k0, nk, more_ids);
        group_sync<kBlock>();  // the last chunk's ptab rows are read
        patch_stage_ptab(b + ldr, F4, ptab, F, more_ids, nk, pvec, gl, G);
        cp_async_commit();
        cp_async_wait_group<0>();
        group_sync<kBlock>();
#pragma unroll
        for (int k = 0; k < kPatchPos; ++k) xs[k] = more_ids.x[k];
      }
#pragma unroll
      for (int k = 0; k < kPatchPos; ++k) {
        if (k >= nk) break;
        const float* pv = b + ldr + 2 * k * F4;  // v_old
        const float* dv = pv + F4;
        const float x = xs[k];
        const float d = own ? dv[f] : 0.f;
        const float h = own ? x * (qb - x * pv[f]) : 0.f;
        float s1 = d * h, t = d * wc;
        group_sums<kBlock>(s1, t, G, red);
        const float m = own ? patch_matvec<kF>(b, lay.wcc, dv, F, f) : 0.f;
        weq -= s1 * wc + x * m;
        dyf -= d * h;
        qb -= x * d;
        we -= s1 * wn + x * t;
      }
    }
    if (rho < nr) {
      float* row = rtab + static_cast<int64_t>(rho) * lay.ld;
      if (own) {
        row[f] = qb;
        row[lay.weq + f] = weq;
        dy[static_cast<int64_t>(rho) * F + f] = dyf;
      }
      if (gl == 0) row[lay.we] = we;
    }
    if (more) {  // the next row's x, then the ids of the row after it
#pragma unroll
      for (int k = 0; k < kPatchPos; ++k) xs[k] = next.x[k];
      next = ids;
      dyf = ndy;
    }
    cur ^= 1;
  }
}

// X10c at F <= 1 (kW: the w mode, mcmc_bs.py:672-676, rows we | wn; else
// F = 1, :802-810, in the reference's grouping, rows qB | we | weq | wc |
// wcc | wn): a thread a relation row, held in registers (8-byte loads
// where the base allows, vec = 2); each chunk of up to kPatchPos
// positions' ids, x and (v_old, dv) is read before its arithmetic, the
// positions in order; we (qB, we, weq) and dy written once.
template <bool kW>
__global__ void __launch_bounds__(kPatchThreads)
    rel_patch_row_kernel(const int* __restrict__ rids,
                         const float* __restrict__ rvals, int64_t R, int Pr,
                         const int* __restrict__ pos, int npos,
                         const float* __restrict__ ptab, int vec, int pvec,
                         float* __restrict__ rtab, float* __restrict__ dy) {
  constexpr int ld = kW ? 2 : 6;
  const int64_t rho =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (rho >= R) return;
  float* row = rtab + rho * ld;
  float r[ld];
  if (vec >= 2) {
#pragma unroll
    for (int i = 0; i < ld / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(row)[i];
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ld; ++i) r[i] = row[i];
  }
  float dyr = dy[rho];
  const int* rid = rids + rho * Pr;
  const float* rx = rvals + rho * Pr;
  for (int k0 = 0; k0 < npos; k0 += kPatchPos) {
    const int nk = min(kPatchPos, npos - k0);
    float xp[kPatchPos], pv[kPatchPos], pd[kPatchPos];
#pragma unroll
    for (int k = 0; k < kPatchPos; ++k) {
      xp[k] = pv[k] = pd[k] = 0.f;
      if (k < nk) {
        const int p = pos[k0 + k];
        const float* g = ptab + 2 * static_cast<int64_t>(rid[p]);
        xp[k] = rx[p];
        if (pvec >= 2) {
          const float2 t = *reinterpret_cast<const float2*>(g);
          pv[k] = t.x;
          pd[k] = t.y;
        } else {
          pv[k] = g[0];
          pd[k] = g[1];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPatchPos; ++k) {
      if (k >= nk) break;
      const float x = xp[k], d = pd[k];
      if constexpr (kW) {
        r[0] -= x * d * r[1];
        dyr -= x * d;
      } else {
        const float h = x * (r[0] - x * pv[k]);
        r[1] -= d * (h * r[5] + x * r[3]);
        r[2] -= d * (h * r[3] + x * r[4]);
        dyr -= d * h;
        r[0] -= x * d;
      }
    }
  }
  if constexpr (kW) {
    row[0] = r[0];
  } else if (vec >= 2) {
    *reinterpret_cast<float2*>(row) = make_float2(r[0], r[1]);
    row[2] = r[2];
  } else {
    row[0] = r[0];
    row[1] = r[1];
    row[2] = r[2];
  }
  dy[rho] = dyr;
}

}  // namespace

// The widest copy (4, 2 or 1 floats) that a row of ld floats at rtab allows.
static int row_vec(int ld, const float* rtab) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(rtab);
  if (ld % 4 == 0 && p % 16 == 0) return 4;
  if (ld % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The blocks an SM holds of X10a's block form in rounds of kRound slots.
template <int kU, bool kRaw, int kRound>
static cudaError_t join_block_fit(int F, int threads, int& fit) {
  auto kernel = join_agg_block_kernel<kU, kRaw, kRound>;
  const size_t smem =
      sizeof(float) * join_block_floats(F, kRaw, kRound, kU, threads);
  fit = 0;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaSuccess;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                        smem);
  return err;
}

// X10a's block form with kU units a thread: rounds of 16 slots where the
// SM holds at least half as many blocks again as at 32 (the unaligned
// layout at small F, whose shared memory, not its registers, limits the
// blocks: more rows in flight ran faster on the H100), else 32 (where the
// registers hold the blocks, halved rounds only add rounds, and ran
// slower); a persistent grid of the blocks the card holds.
template <int kU>
static int launch_join_block(bool raw, const int64_t* plan, int nb,
                             int64_t blocks, const float* e, const float* q,
                             int F, float* rtab, int threads,
                             cudaStream_t stream) {
  int dev = 0, sms = 0, fit32 = 0, fit16 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = raw ? join_block_fit<kU, true, 32>(F, threads, fit32)
              : join_block_fit<kU, false, 32>(F, threads, fit32);
  if (err == cudaSuccess)
    err = raw ? join_block_fit<kU, true, 16>(F, threads, fit16)
              : join_block_fit<kU, false, 16>(F, threads, fit16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool r16 = 2 * fit16 >= 3 * fit32;
  const int fit = r16 ? fit16 : fit32;
  if (fit == 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>(std::min<int64_t>(int64_t{fit} * sms, blocks));
  const size_t smem = sizeof(float) * join_block_floats(F, raw, r16 ? 16 : 32,
                                                        kU, threads);
  auto kernel = r16 ? (raw ? join_agg_block_kernel<kU, true, 16>
                           : join_agg_block_kernel<kU, false, 16>)
                    : (raw ? join_agg_block_kernel<kU, true, 32>
                           : join_agg_block_kernel<kU, false, 32>);
  kernel<<<grid, threads, smem, stream>>>(plan, nb, blocks, e, q, F, rtab);
  return static_cast<int>(cudaGetLastError());
}

// X10a over the nb buckets of a join plan (each [C, L]; rows: data rows,
// cols: relation rows): writes rtab [R, 3F + 2 + P] channels F .. 3F + P
// (F = 0: rtab [R, 2], channel 0) at the buckets' relation rows.  plan is
// the device table [nb, kPlanCols], blocks the buckets' blocks in all:
// ceil(C G / kNarrowThreads) a bucket at F <= 1; at F >= 2 the relation
// rows in all (C a bucket), which the warps (F <= 32) or the blocks
// (F > 32) of a persistent grid walk.
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
  if (F <= kAggMaxF) {  // blocks: the plan's relation rows
    const int vec = row_vec(F, q);
    return with_agg_form(F, [&](auto s, auto j) {
      auto kernel = join_agg_warp_kernel<decltype(s)::value,
                                         decltype(j)::value>;
      const size_t smem =
          sizeof(float) * kAggWarps * kAggBufs * agg_buf(decltype(s)::value);
      cudaError_t err = allow_smem(kernel, smem);
      int dev = 0, sms = 0, per_sm = 0;
      if (err == cudaSuccess) err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, 32 * kAggWarps, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int64_t held = static_cast<int64_t>(std::max(per_sm, 1)) * sms;
      const unsigned warp_grid = static_cast<unsigned>(std::min<int64_t>(
          held, (blocks + kAggWarps - 1) / kAggWarps));
      kernel<<<warp_grid, 32 * kAggWarps, smem, stream>>>(
          plan, nb, blocks, e, q, F, vec, rtab);
      return static_cast<int>(cudaGetLastError());
    });
  }
  // the block form: blocks the plan's relation rows, which the blocks of a
  // persistent grid walk
  const JoinBlockPlan bp = join_block_plan(F);
  if (bp.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool raw = row_vec(F, q) < 4;
  return bp.kU == 1   ? launch_join_block<1>(raw, plan, nb, blocks, e, q, F,
                                             rtab, bp.threads, stream)
         : bp.kU == 2 ? launch_join_block<2>(raw, plan, nb, blocks, e, q, F,
                                             rtab, bp.threads, stream)
                      : launch_join_block<3>(raw, plan, nb, blocks, e, q, F,
                                             rtab, bp.threads, stream);
}

// X10b on one [C, L] bucket of a relation bin (rows: relation rows; cols:
// relation attributes), F factors (F = 0: the w draw), in the form `form`
// (kForm*) with k its lanes a column (kFormGroup; kFormWarp, 8 or 32) or
// rows a tile (kFormTiles, kFormTilesL2); the block forms split each
// column's nreal[c] real entries (its slots up to its last non-zero x) S
// ways, and with S > 1 take part [C, S, nout] as scratch and done [C] as
// zeroed counters (left zeroed).  Writes v_t [Dr, Fo] and ptab's dv
// channels at the bucket's columns; nans += NaN, Inf draws.
SVBFM_EXPORT int svbfm_bs_rel_draw(
    const int* rows, const float* x, int C, int L, int form, int k, int S,
    const int* nreal, const int* cols, const int* group, const float* rtab,
    int F, float* ptab, float* v_t, const float* mu, const float* lam,
    const float* alpha, const float* z, int64_t Dr, int* nans, float* part,
    int* done, cudaStream_t stream) {
  if (C == 0) return static_cast<int>(cudaSuccess);
  const bool w = F == 0;
  const dim3 split(static_cast<unsigned>(C), static_cast<unsigned>(S));
  if (form == kFormGroup && F <= 1) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<int64_t>(C) * k + kDrawThreads - 1) / kDrawThreads);
    if (w) {
      rel_draw_group_kernel<true><<<blocks, kDrawThreads, 0, stream>>>(
          rows, x, C, L, k, cols, group, rtab, ptab, v_t, mu, lam, alpha, z,
          nans);
    } else {
      rel_draw_group_kernel<false><<<blocks, kDrawThreads, 0, stream>>>(
          rows, x, C, L, k, cols, group, rtab, ptab, v_t, mu, lam, alpha, z,
          nans);
    }
  } else if (form == kFormBlock && F <= 1) {
    if (w) {
      rel_draw_block_kernel<true><<<split, kDrawThreads, 0, stream>>>(
          rows, x, L, S, nreal, cols, group, rtab, ptab, v_t, mu, lam, alpha,
          z, nans, part, done);
    } else {
      rel_draw_block_kernel<false><<<split, kDrawThreads, 0, stream>>>(
          rows, x, L, S, nreal, cols, group, rtab, ptab, v_t, mu, lam, alpha,
          z, nans, part, done);
    }
  } else if (form == kFormWarp && F >= 2 &&
             ((k == 8 && F <= 24 && L <= 8) ||
              (k == 32 && F <= 32 * svbfm::kDrawSlots && L <= 32))) {
    const int E = warp_rows(F, k);
    const size_t warp_smem = sizeof(float) * warp_slice(F, E) * (32 / k);
    const int warps = static_cast<int>(kMaxSmem / warp_smem < kDrawWarps
                                           ? kMaxSmem / warp_smem
                                           : kDrawWarps);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = warps * warp_smem;
    const int per_block = warps * (32 / k);  // columns a block
    const unsigned blocks =
        static_cast<unsigned>((C + per_block - 1) / per_block);
    const int vec = row_vec(RelLayout(F).ld, rtab);
    auto kernel = k == 8 ? rel_draw_warp_kernel<8, 3>
                         : svbfm::with_draw_slots(F, [](auto slots) {
                             return rel_draw_warp_kernel<
                                 32, decltype(slots)::value>;
                           });
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, 32 * warps, smem, stream>>>(
        rows, x, C, L, E, vec, cols, group, rtab, F, ptab, v_t, mu, lam,
        alpha, z, Dr, nans);
  } else if ((form == kFormTiles || form == kFormTilesL2) && F >= 2 &&
             F <= 32 * svbfm::kDrawSlots) {
    const bool l2 = form == kFormTilesL2;
    const size_t smem = tiles_smem(F, k, !l2);
    if (k < 1 || smem > static_cast<size_t>(kMaxSmem))
      return static_cast<int>(cudaErrorInvalidValue);
    const int vec = row_vec(RelLayout(F).ld, rtab);
    // rows without wcc are staged past F = 192 only: ten factors a lane
    auto kernel = l2 ? rel_draw_tiles_kernel<true, svbfm::kDrawSlots>
                     : svbfm::with_draw_slots(F, [](auto slots) {
                         return rel_draw_tiles_kernel<
                             false, decltype(slots)::value>;
                       });
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<split, kDrawThreads, smem, stream>>>(
        rows, x, L, S, k, vec, nreal, cols, group, rtab, F, ptab, v_t, mu,
        lam, alpha, z, Dr, nans, part, done);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// X10c's lanes form at 2 <= F <= 32, built for each F (kF = F): a
// persistent grid, the blocks the card holds, each group walking rows.
template <int kF>
static cudaError_t launch_patch_lanes(const int* rids, const float* rvals,
                                      int64_t R, int Pr, const int* pos,
                                      int npos, const float* ptab, int F,
                                      int vec, int pvec, float* rtab,
                                      float* dy, cudaStream_t stream) {
  if constexpr (kF > 32) {
    return cudaErrorInvalidValue;
  } else {
    if (F != kF)
      return launch_patch_lanes<kF + 1>(rids, rvals, R, Pr, pos, npos, ptab,
                                        F, vec, pvec, rtab, dy, stream);
    const int G = patch_lanes(kF);
    const int per = kPatchThreads / G;
    const size_t smem = sizeof(float) * 2 * per * patch_slice(kF);
    auto kernel = rel_patch_group_kernel<false, kF>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, fit = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          kPatchThreads, smem);
    if (err != cudaSuccess) return err;
    const int64_t need = (R + per - 1) / per;
    const int64_t most = static_cast<int64_t>(sms) * (fit > 0 ? fit : 1);
    kernel<<<static_cast<unsigned>(need < most ? need : most), kPatchThreads,
             smem, stream>>>(rids, rvals, R, Pr, pos, npos, ptab, kF, G, vec,
                             pvec, rtab, dy);
    return cudaGetLastError();
  }
}

// X10c: patch rtab's qB, we, weq (F = 0: we) and dy [R, Fo] in place over
// the row-layout positions pos [npos] of rids/rvals [R, Pr], from ptab
// [Dr, 2Fo] = (v_old, dv), in the form patch_plan gives F (see above).
SVBFM_EXPORT int svbfm_bs_rel_patch(const int* rids, const float* rvals,
                                    int64_t R, int Pr, const int* pos,
                                    int npos, const float* ptab, int F,
                                    float* rtab, float* dy,
                                    cudaStream_t stream) {
  if (R == 0 || npos == 0) return static_cast<int>(cudaSuccess);
  if (R > INT32_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  const RelLayout lay(F);
  const int vec = row_vec(lay.ld, rtab);
  // ptab rows: 2 floats at F <= 1; at F >= 2 v_old and dv, F floats each
  const int pvec = row_vec(F > 1 ? F : 2, ptab);
  if (F <= 1) {
    const unsigned blocks =
        static_cast<unsigned>((R + kPatchThreads - 1) / kPatchThreads);
    if (F == 0) {
      rel_patch_row_kernel<true><<<blocks, kPatchThreads, 0, stream>>>(
          rids, rvals, R, Pr, pos, npos, ptab, vec, pvec, rtab, dy);
    } else {
      rel_patch_row_kernel<false><<<blocks, kPatchThreads, 0, stream>>>(
          rids, rvals, R, Pr, pos, npos, ptab, vec, pvec, rtab, dy);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (F <= 32)
    return static_cast<int>(launch_patch_lanes<2>(rids, rvals, R, Pr, pos,
                                                  npos, ptab, F, vec, pvec,
                                                  rtab, dy, stream));
  const int threads = (F + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (patch_slice(F) + 2 * (threads / 32));
  if (threads > kPatchThreads || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(rel_patch_group_kernel<true, 0>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rel_patch_group_kernel<true, 0><<<static_cast<unsigned>(R), threads, smem,
                                    stream>>>(rids, rvals, R, Pr, pos, npos,
                                              ptab, F, threads, vec, pvec,
                                              rtab, dy);
  return static_cast<int>(cudaGetLastError());
}

// X10b's w mode (mcmc_bs.py:650-669): the F = 0 layout rtab [R, 2] =
// (we, wn); w [Dr] and ptab [Dr, 2] = (w_old, dw) as v_t and ptab at Fo = 1;
// mu/lam [G] the w group priors; z [Dr] or nullptr; form kFormGroup or
// kFormBlock.
SVBFM_EXPORT int svbfm_bs_rel_w_draw(
    const int* rows, const float* x, int C, int L, int form, int k, int S,
    const int* nreal, const int* cols, const int* group, const float* rtab,
    float* ptab, float* w, const float* mu, const float* lam,
    const float* alpha, const float* z, int64_t Dr, int* bad, float* part,
    int* done, cudaStream_t stream) {
  return svbfm_bs_rel_draw(rows, x, C, L, form, k, S, nreal, cols, group,
                           rtab, 0, ptab, w, mu, lam, alpha, z, Dr, bad,
                           part, done, stream);
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
