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
// [0, len) returns the sentinel itself (0xFE for a, 0xFD for b, which never
// compare equal).  In-row zero padding compares as data, exactly as the
// gather path of cluster_utils.match_run_left/right does.
//
// What bounds it on this card: latency, not bandwidth.  At most `window`
// (48) byte pairs are read per cluster.  In the forward step only mixed
// clusters (a few per hundred items) have a nonzero limit; in the left
// shift's homology run (backward, on the reversed contig's window) every
// cluster has one, mostly far above the window and clamped to it, and the
// run stops at the first mismatch.  A B=512 x C=96 launch touches a few
// hundred KB; the time is the launch plus one dependent load chain.
//
// Design: the TPU kernel held both padded rows in VMEM per grid cell and
// realigned 128-lane windows with rolls.  Here each thread walks its own
// compare with direct byte loads through the read-only cache and stops at the
// first mismatch; clusters with limit <= 0 (the common case) exit after one
// load of their limit.  No shared memory, no synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void match_run_kernel(
    const uint8_t* __restrict__ a, int len_a, const uint8_t* __restrict__ b,
    int len_b, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    const int32_t* __restrict__ limit, int n_items, int n_clusters,
    int window, int rev, int32_t* __restrict__ run_out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_items * n_clusters) return;
  const long long item = k / n_clusters;
  const uint8_t* ra = a + item * len_a;
  const uint8_t* rb = b + item * len_b;
  int lim = __ldg(limit + k);
  lim = lim < 0 ? 0 : (lim > window ? window : lim);
  const long long sa = __ldg(ia + k), sb = __ldg(ib + k);
  const long long step = rev ? -1 : 1;
  long long pa = rev ? sa - 1 : sa;
  long long pb = rev ? sb - 1 : sb;
  int run = 0;
  for (; run < lim; ++run, pa += step, pb += step) {
    const int va = (pa >= 0 && pa < len_a) ? __ldg(ra + pa) : 0xFE;
    const int vb = (pb >= 0 && pb < len_b) ? __ldg(rb + pb) : 0xFD;
    if (va != vb) break;
  }
  run_out[k] = run;
}

}  // namespace

extern "C" int ptt_match_run(const void* a, int len_a, const void* b,
                             int len_b, const void* ia, const void* ib,
                             const void* limit, int n_items, int n_clusters,
                             int window, int rev, void* run, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    match_run_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), len_a,
        static_cast<const uint8_t*>(b), len_b,
        static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        static_cast<const int32_t*>(limit), n_items, n_clusters, window, rev,
        static_cast<int32_t*>(run));
  }
  return static_cast<int>(cudaGetLastError());
}
