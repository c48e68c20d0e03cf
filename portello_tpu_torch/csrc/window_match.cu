// Window runs of mixed indel clusters (stage 4 of the resident forward
// step), one thread per (item, cluster).
//
// Replaces the TPU kernel
//   portello_tpu/kernels/pallas/window_match.py :: window_match_runs_batch
//   (body _window_match_kernel, layout pad_table)
// through two entry points that share the compare in window_runs.h:
//
//   ptt_window_runs_resident -- the main path.  For every (item b, cluster
//     c) with mixed[b, c]: raw_r, the trailing equal run of the resident
//     genome at g_base[b] + bs + dl - W + t against read base rs + il - W + t,
//     and raw_l, the leading equal run of the genome at g_base[b] + bs + t
//     against read base rs + t, t in [0, W).  Read bases are decoded from
//     the packed BAM-nibble row.  Clusters that are not mixed write 0.
//     Genome offsets are int64: a GRCh38-sized genome passes 2^31 bytes.
//   ptt_window_match -- the Pallas kernel's own contract: the leading and
//     trailing runs of a[ia:ia+W] against b[ib:ib+W] on (B, nsb, 128)
//     pad_table tables.
//
// What bounds it on this card: latency.  Mixed clusters are a few per
// hundred items, so a B=512 x C=96 launch compares a few thousand windows
// of 48 bytes; the time is the launch and one chain of dependent loads.
//
// Design: the TPU kernel pulled 128-byte superblocks out of VMEM tables
// with one-hot matmuls and realigned them with a barrel shifter, because
// Mosaic has no dynamic lane slice.  Here each thread loads its bytes
// directly through the read-only cache, stops at the first mismatch, and
// a cluster that is not mixed exits after one load of its mask.  The
// resident genome is indexed in place; no window table is built.  The
// launch covers all B x C pairs: compacting the mixed ones on the host
// would cost a device sync per batch.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_runs.h"

namespace {

constexpr int kThreads = 256;

__global__ void window_runs_resident_kernel(
    const uint8_t* __restrict__ genome, long long genome_nsb,
    const long long* __restrict__ g_base, const uint8_t* __restrict__ packed,
    int lp, const int32_t* __restrict__ bs, const int32_t* __restrict__ rs,
    const int32_t* __restrict__ dl, const int32_t* __restrict__ il,
    const uint8_t* __restrict__ mixed, int n_items, int n_clusters,
    int window, int32_t* __restrict__ raw_r, int32_t* __restrict__ raw_l) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_items * n_clusters) return;
  if (!__ldg(mixed + k)) {
    raw_r[k] = 0;
    raw_l[k] = 0;
    return;
  }
  const long long item = k / n_clusters;
  int32_t r, l;
  ptt::resident_cluster_runs(
      ptt::DirectLoad{genome}, genome_nsb, __ldg(g_base + item),
      ptt::DirectLoad{packed + item * lp}, lp, __ldg(bs + k), __ldg(rs + k),
      __ldg(dl + k), __ldg(il + k), window, &r, &l);
  raw_r[k] = r;
  raw_l[k] = l;
}

__global__ void window_match_kernel(
    const uint8_t* __restrict__ a_tab, const uint8_t* __restrict__ b_tab,
    int nsb, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    int n_items, int n_clusters, int window, int32_t* __restrict__ run_fwd,
    int32_t* __restrict__ run_rev) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_items * n_clusters) return;
  const long long row = (k / n_clusters) * (long long)nsb * 128;
  int32_t f, r;
  ptt::table_cluster_runs(ptt::DirectLoad{a_tab + row},
                          ptt::DirectLoad{b_tab + row}, nsb, __ldg(ia + k),
                          __ldg(ib + k), window, &f, &r);
  run_fwd[k] = f;
  run_rev[k] = r;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int ptt_window_runs_resident(
    const void* genome, long long genome_len, const void* g_base,
    const void* packed, int lp, const void* bs, const void* rs,
    const void* dl, const void* il, const void* mixed, int n_items,
    int n_clusters, int window, void* raw_r, void* raw_l, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    window_runs_resident_kernel<<<blocks_for(total), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(genome), genome_len / 64,
        static_cast<const long long*>(g_base),
        static_cast<const uint8_t*>(packed), lp,
        static_cast<const int32_t*>(bs), static_cast<const int32_t*>(rs),
        static_cast<const int32_t*>(dl), static_cast<const int32_t*>(il),
        static_cast<const uint8_t*>(mixed), n_items, n_clusters, window,
        static_cast<int32_t*>(raw_r), static_cast<int32_t*>(raw_l));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_window_match(const void* a_tab, const void* b_tab,
                                int nsb, const void* ia, const void* ib,
                                int n_items, int n_clusters, int window,
                                void* run_fwd, void* run_rev, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    window_match_kernel<<<blocks_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a_tab), static_cast<const uint8_t*>(b_tab),
        nsb, static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        n_items, n_clusters, window, static_cast<int32_t*>(run_fwd),
        static_cast<int32_t*>(run_rev));
  }
  return static_cast<int>(cudaGetLastError());
}
