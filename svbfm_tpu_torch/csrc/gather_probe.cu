// P1: the gather-cost probe, o[r, l] = t[i[r, l], l].
//
// Replaces scripts/pallas_gather_probe.py:main (:83), the repository's one
// pl.pallas_call: a take_along_axis of a [depth, 128] table held in the
// TPU's VMEM, which Mosaic lowers only at depth 8, probed beside XLA's 1-D
// take and lane-local take_along_axis.  On Hopper every form is the same
// kernel: a table of W lanes (W = 1 for the 1-D gather, 128 for the
// lane-local form) and one index per output element.  One thread per
// output element, consecutive threads on consecutive lanes, so the index
// and output traffic is coalesced and only the table reads land at
// data-dependent addresses.
//
// Bound: the latency and sector traffic of the table reads (one 32-byte
// sector per index when W = 1); each index and output is four bytes
// streamed once.  Its time per index is the gather cost that bounds the
// sweep kernels K3, K4, X8a and X8b (PERF.md).
#include "svbfm_common.cuh"

namespace {

__global__ void gather_kernel(const float* __restrict__ t,
                              const int* __restrict__ idx, int64_t n, int W,
                              float* __restrict__ o) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t l = i % W;
  o[i] = t[static_cast<int64_t>(idx[i]) * W + l];
}

}  // namespace

// o [n] = t[idx[i] * W + i % W] for i < n: t is [S, W], idx and o [n / W, W]
SVBFM_EXPORT int svbfm_gather_probe(const float* t, const int* idx, int64_t n,
                                    int W, float* o, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  gather_kernel<<<blocks, threads, 0, stream>>>(t, idx, n, W, o);
  return static_cast<int>(cudaGetLastError());
}
