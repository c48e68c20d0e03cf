// Bounded-window common run between two byte rows, one thread per
// (item, cluster).
//
// Replaces the TPU kernel
//   portello_tpu/kernels/pallas/match_run_pallas.py :: match_run_batch_pallas
//   (body _match_run_kernel)
// with the same contract, per (item b, cluster c):
//   forward  (rev = 0): a[ia + t] == b[ib + t]
//   backward (rev = 1): a[ia - 1 - t] == b[ib - 1 - t]
// run = the number of leading t in [0, min(limit, window)) that compare
// equal.  The Pallas kernel needs both rows padded with `window` sentinel
// bytes and the starts pre-offset; here the rows are the unpadded
// (B, max_seq) uint8 tables the slots already hold, and a read outside
// [0, len) returns the sentinel itself (0xFE for a, 0xFD for b).  In-row
// zero padding compares as data, exactly as the gather path of
// cluster_utils.match_run_left/right does.
//
// What bounds it on this card: latency, not bandwidth.  At most `window`
// (48) byte pairs are read per cluster.  In the forward step only 1/1 and
// mixed clusters have a nonzero limit; in the left shift's homology run
// (backward, on the reversed contig's window) every cluster has one, mostly
// far above the window and clamped to it, and most runs end at t = 0 or 1.
// A B=512 x C=96 launch touches a few hundred KB.  A byte walk (one
// dependent load per position) pays r + 1 memory round trips for a run r,
// and a warp waits for its longest run.  Where every pair is live, the
// scattered vector loads themselves, and at C=512 the device-memory
// sectors they touch, take the time.
//
// Design: the TPU kernel held both padded rows in VMEM per grid cell and
// realigned 256-byte supersets with rolls.  Here each thread loads its
// pair's limit and starts (coalesced, volatile so that the compiler cannot
// sink the starts' loads under the test of the limit), then every byte its
// compare might need as independent 16-byte vector loads, and only then
// compares (match_run.h): two dependent round trips per pair whatever its
// run.  The compare realigns a word only when it reaches it and stops at
// the first that differs, so a short run costs a few instructions; pairs
// with limit <= 0 load no row data.  A block takes clusters of one item
// (grid y), so no division precedes the first load.  No shared memory, no
// synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

#include "match_run.h"

namespace {

// Threads per block: at most 128 (faster than 256 on every shape of
// chip_smoke.py phase 3, scripts/torch_kernel_ablations.py), fewer where
// an item has fewer clusters.
constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

// An argument load that stays where it stands: with __ldg the compiler
// sank the loads of the starts under the test of the limit, a third
// dependent round trip for every live pair.  A volatile load is issued
// exactly where the program puts it.
__device__ __forceinline__ int32_t load_arg(const int32_t* p) {
  int32_t v;
  asm volatile("ld.volatile.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Block (x, y) takes clusters [x * blockDim, (x + 1) * blockDim) of items
// y, y + grid.y, ...: no division on the way to the first load.
template <bool kRev>
__global__ void __launch_bounds__(kThreads) match_run_kernel(
    const uint8_t* __restrict__ a, int len_a, const uint8_t* __restrict__ b,
    int len_b, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    const int32_t* __restrict__ limit, int n_items, int n_clusters,
    int window, int32_t* __restrict__ run_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_clusters) return;
  for (long long item = blockIdx.y; item < n_items; item += gridDim.y) {
    const long long k = item * n_clusters + c;
    // the three arguments in one round trip, before any row byte
    const int32_t lim = load_arg(limit + k);
    const int32_t sa = load_arg(ia + k), sb = load_arg(ib + k);
    run_out[k] = ptt::match_run_one<kRev>(a + item * len_a, len_a,
                                          b + item * len_b, len_b, sa, sb,
                                          lim, window);
  }
}

}  // namespace

extern "C" int ptt_match_run(const void* a, int len_a, const void* b,
                             int len_b, const void* ia, const void* ib,
                             const void* limit, int n_items, int n_clusters,
                             int window, int rev, void* run, void* stream) {
  if (n_items > 0 && n_clusters > 0) {
    const int warps = (n_clusters + 31) / 32;
    const int threads = warps * 32 < kThreads ? warps * 32 : kThreads;
    const dim3 grid((n_clusters + threads - 1) / threads,
                    n_items < kMaxGridY ? n_items : kMaxGridY);
    auto kernel = rev ? match_run_kernel<true> : match_run_kernel<false>;
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), len_a,
        static_cast<const uint8_t*>(b), len_b,
        static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        static_cast<const int32_t*>(limit), n_items, n_clusters, window,
        static_cast<int32_t*>(run));
  }
  return static_cast<int>(cudaGetLastError());
}
