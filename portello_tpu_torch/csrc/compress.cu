// Fused edge-indel cleanup + CIGAR compress: each item's row staged in
// shared memory, one contiguous segment of ops per lane, one scan.
//
// Replaces the TPU kernel
//   portello_tpu/kernels/pallas/compress_pallas.py :: cleanup_and_compress_batch
//   (body _kernel)
// and computes exactly portello_tpu.kernels.cigar_kernels.cleanup_and_compress
// in exact int32, with no 2^16 limit on op lengths (the Pallas kernel flags
// lengths >= 2^16 because it sums bf16 byte planes on the MXU; plain integer
// adds need no such limit).
//
// What bounds it on this card: latency.  Per item the pass reads K codes and
// K lens and writes max_out codes and lens: K = 352 and 464 at the forward
// step's lift and finish sites (up to 3600 in the widest bucket), and the
// odd K = 2 * max_ops + 1 (257..2049) of the left shift's stage-B stream,
// whose tail may hold zero-length non-PAD ops.  A B=512 batch moves 1.6-22
// MB, 0.5-7 us of HBM time; the work is a scan along each row, a dependent
// chain.
//
// Design: the TPU kernel built a (max_out, K) one-hot mask per item in VMEM
// and contracted it on the MXU.  Here kWarpsPerItem warps own an item, in a
// block of 128 threads.
//   1. Staging: the item's codes and lens rows go to shared memory with
//      cp.async, every copy issued before any is awaited: 16-byte copies
//      for the aligned middle of a row, 4-byte copies for its ragged head
//      and tail (odd K leaves rows only 4-byte aligned), so each row costs
//      one memory round trip, not one per 32-op chunk.
//   2. Each lane owns a contiguous segment of ceil(K / lanes) ops (rounded
//      up to odd, so the lanes' shared-memory reads hit distinct banks),
//      which it reads 4 ops at a time, all 4 reads in flight together.
//      It finds its first and last align match; a warp reduce and an
//      exchange through shared memory give the item's.
//   3. The lane cleans up its ops and folds them into a RunSummary
//      (compress_scan.h): run count, first and last kept code, the open
//      run's length, the leading-D shift.  One warp scan of the summaries
//      under their associative combine, and a combine of the item's warp
//      totals through shared memory, gives each lane the state before its
//      segment.
//   4. The lane walks its segment again from that state and writes run
//      codes and closed run lengths to shared memory; the last lane writes
//      the final run's length.  Then the item's threads store max_out codes
//      and lens, PAD-filled, as coalesced rows.
// Nothing is summed twice, and no state crosses items.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "compress_scan.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
// Four warps per item beat one and two at every K from 257 to 3600 on an
// H100, or tied within noise (scripts/torch_kernel_ablations.py): more lanes
// make shorter segments.  The kernel is right for any value that divides
// kThreads / 32.
constexpr int kWarpsPerItem = 4;
constexpr int kLanes = 32 * kWarpsPerItem;   // lanes per item
constexpr int kItems = kThreads / kLanes;    // items per block
constexpr int kScratch = 8;  // words of shared scratch per warp

struct SmemOut {
  int32_t* codes;
  int32_t* lens;
  __host__ __device__ void code(int r, int c) { codes[r] = c; }
  __host__ __device__ void len(int r, int32_t l) { lens[r] = l; }
};

constexpr int round4(int n) { return (n + 3) & ~3; }

// Copies row[0, k) to dst[h, h + k), h = the row's misalignment in words
// (dst is 16-byte aligned), issuing every copy before any is awaited.
// Returns h.  Thread t of nt copies its share.
__device__ __forceinline__ int stage_row(const int32_t* __restrict__ row,
                                         int k, int32_t* dst, int t, int nt) {
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int head = min(k, (4 - h) & 3);
  const int nvec = (k - head) >> 2;
  for (int i = t; i < head; i += nt)
    __pipeline_memcpy_async(dst + h + i, row + i, 4);
  for (int j = t; j < nvec; j += nt)
    __pipeline_memcpy_async(dst + h + head + 4 * j, row + head + 4 * j, 16);
  for (int i = head + 4 * nvec + t; i < k; i += nt)
    __pipeline_memcpy_async(dst + h + i, row + i, 4);
  return h;
}

// Calls f(i, code, len) for i in [lo, hi) in order, reading the lane's
// segment from shared memory kChunk ops at a time: every read of a chunk is
// issued before the first call, so the reads overlap instead of each
// waiting for the one before.  The test against hi differs between lanes
// only in the last lanes of an item, so it rarely diverges.  Four ops a
// chunk: the main path's segments are 3 and 5 ops long, and the warps of an
// SM share its issue slots, so reads and calls past hi are not free.
constexpr int kChunk = 4;

template <class F>
__device__ __forceinline__ void for_segment(const int32_t* c_row,
                                            const int32_t* l_row, int lo,
                                            int hi, F&& f) {
  for (int base = lo; base < hi; base += kChunk) {
    int c[kChunk], l[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool in = base + j < hi;
      c[j] = in ? c_row[base + j] : ptt::kPad;
      l[j] = in ? l_row[base + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (base + j < hi) f(base + j, c[j], l[j]);
  }
}

__device__ __forceinline__ ptt::RunSummary shfl_summary(
    const ptt::RunSummary& s, int src) {
  return ptt::unpack_summary(__shfl_sync(kFull, ptt::pack_codes(s), src),
                             __shfl_sync(kFull, s.tail, src),
                             __shfl_sync(kFull, s.shift, src));
}

__device__ __forceinline__ ptt::RunSummary warp_inclusive(ptt::RunSummary s,
                                                          int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const ptt::RunSummary o = ptt::unpack_summary(
        __shfl_up_sync(kFull, ptt::pack_codes(s), off),
        __shfl_up_sync(kFull, s.tail, off), __shfl_up_sync(kFull, s.shift, off));
    if (lane >= off) s = ptt::combine(o, s);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) cleanup_and_compress_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ lens,
    int n_items, int k, int max_out, int in_stride, int out_stride,
    int32_t* __restrict__ out_codes, int32_t* __restrict__ out_lens,
    int32_t* __restrict__ n_out, int32_t* __restrict__ shift_out,
    uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / kWarpsPerItem;  // item within the block
  const int wi = warp % kWarpsPerItem;    // warp within the item
  const int t = wi * 32 + lane;     // lane within the item
  const int item = blockIdx.x * kItems + slot;
  const bool live = item < n_items;
  const int kk = live ? k : 0;
  int32_t* s_codes = smem + slot * (2 * in_stride + 2 * out_stride);
  int32_t* s_lens = s_codes + in_stride;
  int32_t* o_codes = s_lens + in_stride;
  int32_t* o_lens = o_codes + out_stride;
  int32_t* scratch = smem + kItems * (2 * in_stride + 2 * out_stride);

  // 1. staging
  int hc = 0, hl = 0;
  if (live) {
    hc = stage_row(codes + (size_t)item * k, k, s_codes, t, kLanes);
    hl = stage_row(lens + (size_t)item * k, k, s_lens, t, kLanes);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int32_t* c_row = s_codes + hc;
  const int32_t* l_row = s_lens + hl;
  const int seg = ptt::segment_len(kk > 0 ? kk : 1, kLanes);
  const int lo = min(t * seg, kk), hi = min(lo + seg, kk);

  // 2. first and last align match
  int first = kk, last = -1;
  for_segment(c_row, l_row, lo, hi, [&](int i, int c, int) {
    const bool am = ptt::is_align_match(c);
    first = (am && first == kk) ? i : first;
    last = am ? i : last;
  });
  first = __reduce_min_sync(kFull, first);
  last = __reduce_max_sync(kFull, last);
  uint32_t* mine = reinterpret_cast<uint32_t*>(scratch + warp * kScratch);
  const uint32_t* item_scratch = reinterpret_cast<const uint32_t*>(
      scratch + slot * kWarpsPerItem * kScratch);
  if (lane == 0) {
    mine[0] = static_cast<uint32_t>(first);
    mine[1] = static_cast<uint32_t>(last);
  }
  __syncthreads();
  for (int w = 0; w < kWarpsPerItem; ++w) {
    first = min(first, static_cast<int>(item_scratch[w * kScratch]));
    last = max(last, static_cast<int>(item_scratch[w * kScratch + 1]));
  }

  // 3. the segment's summary, then the scan
  ptt::RunSummary s = ptt::empty_summary();
  for_segment(c_row, l_row, lo, hi, [&](int i, int c, int l) {
    uint32_t sh;
    ptt::clean_op(i, first, last, &c, &l, &sh);
    ptt::summary_push(&s, c, l, sh);
  });
  const ptt::RunSummary incl = warp_inclusive(s, lane);
  ptt::RunSummary before = shfl_summary(incl, lane > 0 ? lane - 1 : 0);
  if (lane == 0) before = ptt::empty_summary();
  if (lane == 31) {
    mine[2] = ptt::pack_codes(incl);
    mine[3] = incl.tail;
    mine[4] = incl.shift;
  }
  __syncthreads();
  ptt::RunSummary prior = ptt::empty_summary();
  ptt::RunSummary total = ptt::empty_summary();
  for (int w = 0; w < kWarpsPerItem; ++w) {
    const uint32_t* other = item_scratch + w * kScratch;
    const ptt::RunSummary agg =
        ptt::unpack_summary(other[2], other[3], other[4]);
    if (w < wi) prior = ptt::combine(prior, agg);
    total = ptt::combine(total, agg);
  }
  before = ptt::combine(prior, before);

  // 4. runs to shared memory, then coalesced rows
  SmemOut out{o_codes, o_lens};
  ptt::Emitter emit(before);
  for_segment(c_row, l_row, lo, hi, [&](int i, int c, int l) {
    uint32_t sh;
    ptt::clean_op(i, first, last, &c, &l, &sh);
    emit.push(c, l, max_out, out);
  });
  if (t == kLanes - 1 && total.runs > 0 && total.runs - 1 < max_out)
    o_lens[total.runs - 1] = static_cast<int32_t>(total.tail);
  __syncthreads();
  if (!live) return;
  const int n_kept = min(total.runs, max_out);
  int32_t* oc = out_codes + (size_t)item * max_out;
  int32_t* ol = out_lens + (size_t)item * max_out;
  for (int r = t; r < max_out; r += kLanes) {
    const bool v = r < n_kept;
    oc[r] = v ? o_codes[r] : ptt::kPad;
    ol[r] = v ? o_lens[r] : 0;
  }
  if (t == 0) {
    n_out[item] = n_kept;
    shift_out[item] = static_cast<int32_t>(total.shift);
    overflow[item] = total.runs > max_out ? 1 : 0;
  }
}

}  // namespace

extern "C" int ptt_cleanup_and_compress(
    const void* codes, const void* lens, int n_items, int k, int max_out,
    void* out_codes, void* out_lens, void* n_out, void* shift, void* overflow,
    void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  // a row starts up to 3 words into its 16-byte aligned slot
  const int in_stride = round4(k + 3), out_stride = round4(max_out);
  const size_t smem =
      sizeof(int32_t) * ((size_t)kItems * (2 * in_stride + 2 * out_stride) +
                         (kThreads / 32) * kScratch);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cleanup_and_compress_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n_items + kItems - 1) / kItems;
  cleanup_and_compress_kernel<<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(lens),
      n_items, k, max_out, in_stride, out_stride,
      static_cast<int32_t*>(out_codes), static_cast<int32_t*>(out_lens),
      static_cast<int32_t*>(n_out), static_cast<int32_t*>(shift),
      static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
