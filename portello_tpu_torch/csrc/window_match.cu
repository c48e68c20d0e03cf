// Window runs of mixed indel clusters (stage 4 of the resident forward
// step).
//
// Replaces the TPU kernel
//   portello_tpu/kernels/pallas/window_match.py :: window_match_runs_batch
//   (body _window_match_kernel, layout pad_table)
// through two entry points that share the byte sources of window_runs.h:
//
//   ptt_window_runs_resident -- the main path.  For every (item b, cluster
//     c) with mixed[b, c]: raw_r, the trailing equal run of the resident
//     genome at g_base[b] + bs + dl - W + t against read base rs + il - W + t,
//     and raw_l, the leading equal run of the genome at g_base[b] + bs + t
//     against read base rs + t, t in [0, W), W <= 64.  Read bases are
//     decoded from the packed BAM-nibble row.  Clusters that are not mixed
//     write 0.  Genome offsets are int64: a GRCh38-sized genome passes 2^31
//     bytes.
//   ptt_window_match -- the Pallas kernel's own contract: the leading and
//     trailing runs of a[ia:ia+W] against b[ib:ib+W] on (B, nsb, 128)
//     pad_table tables, one thread per pair.  Off the main path.
//
// What bounds it on this card: latency.  Mixed clusters are a few per
// hundred, so a B=512 x C=96 launch needs 9 bytes per pair (the mask and
// the two outputs) and about 160 bytes per mixed pair (its arguments, two
// genome windows and two packed read windows): about 1 MB, a third of a
// microsecond of HBM time.  What costs is the chain of dependent loads: the
// mask, a pair's arguments, then its windows, whose genome bytes are a
// random access into 3.1 GB.
//
// Design: the TPU kernel pulled 128-byte superblocks out of VMEM tables
// with one-hot matmuls and realigned them with a barrel shifter.  Here a
// warp owns 32 consecutive pairs.  It loads their mask bytes, arguments and
// genome bases coalesced, all at once (16 bytes more per pair than the mixed
// pairs need, which saves a dependent round trip), and ballots the mixed
// lanes.  It then takes the mixed pairs kGroup at a time: for each, every
// lane loads position t = lane (and lane + 32) of all four windows, so a
// window costs one load per lane, not a walk; the packed read bytes stay
// undecoded until the round's loads are issued (a decode right after its
// load made the next load wait for it).  Then, per pair, the lanes decode
// and compare, one ballot per window half gives the mismatch mask, and
// __ffsll / __clzll its leading and trailing runs.  No lane idles while
// another walks a window.  The results go out coalesced, zeros included.
// The launch covers all B x C pairs: compacting the mixed ones on the host
// would cost a device sync per batch.
//
// What is left: timing each warp on an H100 showed a round's pairs still
// costing about one memory latency each, so the warps with the most mixed
// pairs end last; a round that loads every slot without a branch measured
// no faster.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_runs.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Mixed pairs per round: 2 and 8 measured no faster on an H100 (8 takes
// 115 registers a thread against 58).
constexpr int kGroup = 4;
constexpr unsigned kFull = 0xffffffffu;

using Pair = ptt::ResidentPair<ptt::DirectLoad, ptt::DirectLoad>;

__global__ void __launch_bounds__(kThreads) window_runs_resident_kernel(
    const uint8_t* __restrict__ genome, long long genome_nsb,
    const long long* __restrict__ g_base, const uint8_t* __restrict__ packed,
    int lp, const int32_t* __restrict__ bs, const int32_t* __restrict__ rs,
    const int32_t* __restrict__ dl, const int32_t* __restrict__ il,
    const uint8_t* __restrict__ mixed, int n_items, int n_clusters,
    int window, int32_t* __restrict__ raw_r, int32_t* __restrict__ raw_l) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)n_items * n_clusters;
  const long long first_pair =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (first_pair >= total) return;  // warp-uniform
  const long long k = first_pair + lane;
  const bool in = k < total;
  const long long a_item = in ? k / n_clusters : 0;
  const bool mine = in && __ldg(mixed + k);
  const int32_t a_bs = in ? __ldg(bs + k) : 0;
  const int32_t a_rs = in ? __ldg(rs + k) : 0;
  const int32_t a_dl = in ? __ldg(dl + k) : 0;
  const int32_t a_il = in ? __ldg(il + k) : 0;
  const long long a_base = in ? __ldg(g_base + a_item) : 0;
  int32_t out_r = 0, out_l = 0;
  const int t0 = lane, t1 = lane + 32;
  unsigned todo = __ballot_sync(kFull, mine);
  while (todo) {  // warp-uniform
    int src[kGroup];
    int v[kGroup][8];     // ref, read byte, ref, read byte at t0; then at t1
    int parity[kGroup];   // bit 0: read_r's start is odd; bit 1: read_l's
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      src[g] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      const int s = src[g] < 0 ? 0 : src[g];
      const int32_t p_bs = __shfl_sync(kFull, a_bs, s);
      const int32_t p_rs = __shfl_sync(kFull, a_rs, s);
      const int32_t p_dl = __shfl_sync(kFull, a_dl, s);
      const int32_t p_il = __shfl_sync(kFull, a_il, s);
      const long long p_item = __shfl_sync(kFull, a_item, s);
      const long long p_base = __shfl_sync(kFull, a_base, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[g][j] = 0;
      parity[g] = 0;
      if (src[g] >= 0) {
        const Pair p(ptt::DirectLoad{genome}, genome_nsb, p_base,
                     ptt::DirectLoad{packed + p_item * lp}, lp, p_bs, p_rs,
                     p_dl, p_il, window);
        parity[g] = int(p.read_r.start & 1) | (int(p.read_l.start & 1) << 1);
        if (t0 < window) {
          v[g][0] = p.ref_r(t0);
          v[g][1] = p.read_r.raw(t0);
          v[g][2] = p.ref_l(t0);
          v[g][3] = p.read_l.raw(t0);
        }
        if (t1 < window) {
          v[g][4] = p.ref_r(t1);
          v[g][5] = p.read_r.raw(t1);
          v[g][6] = p.ref_l(t1);
          v[g][7] = p.read_l.raw(t1);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (src[g] < 0) break;  // warp-uniform
      const int pr = parity[g] & 1, pl = parity[g] >> 1;
      const bool d0r = t0 < window && v[g][0] != ptt::decode_packed(v[g][1], pr + t0);
      const bool d0l = t0 < window && v[g][2] != ptt::decode_packed(v[g][3], pl + t0);
      const bool d1r = t1 < window && v[g][4] != ptt::decode_packed(v[g][5], pr + t1);
      const bool d1l = t1 < window && v[g][6] != ptt::decode_packed(v[g][7], pl + t1);
      const uint64_t mis_r = __ballot_sync(kFull, d0r) |
                             (uint64_t(__ballot_sync(kFull, d1r)) << 32);
      const uint64_t mis_l = __ballot_sync(kFull, d0l) |
                             (uint64_t(__ballot_sync(kFull, d1l)) << 32);
      if (lane == src[g]) {
        out_r = ptt::trailing_run_from_mismatch(mis_r, window);
        out_l = ptt::leading_run_from_mismatch(mis_l, window);
      }
    }
  }
  if (in) {
    raw_r[k] = out_r;
    raw_l[k] = out_l;
  }
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
