// Fused edge-indel cleanup + CIGAR compress, one warp per item.
//
// Replaces the TPU kernel
//   portello_tpu/kernels/pallas/compress_pallas.py :: cleanup_and_compress_batch
//   (body _kernel)
// and computes exactly portello_tpu.kernels.cigar_kernels.cleanup_and_compress
// in exact int32, with no 2^16 limit on op lengths (the Pallas kernel flags
// lengths >= 2^16 because it sums bf16 byte planes on the MXU; plain integer
// adds need no such limit).
//
// What bounds it on this card: nothing wide.  Per item the pass reads K codes
// and K lens and writes max_out codes and lens: K = 352..3600 int32 at the
// forward step's lift and finish sites, and the odd K = 2 * max_ops + 1
// (257..2049) of the left shift's stage-B stream, whose last 32-lane chunk
// is partial and may hold zero-length non-PAD ops.  A B=512 batch moves a
// few MB -- microseconds of HBM time.  The work is a
// chain of dependent warp-level scans (first/last align-match, previous kept
// code, run starts, prefix sums of kept lengths), so the kernel is bound by
// instruction latency along that chain, not by bytes or arithmetic.
//
// Design: the TPU kernel built a (max_out, K) one-hot mask per item in VMEM
// and contracted it on the MXU.  Here one warp walks its item's K ops in
// 32-wide chunks and carries the scan state (previous kept code, run count,
// kept-length prefix, the open run) from chunk to chunk in registers.  Within
// a chunk, ballots and shuffles give the previous kept code, the run starts
// and the kept-length prefix sum; a run's length is the difference of the
// prefix sums at its start and at the next run's start, so no run is summed
// twice and nothing is written to memory but the outputs.  Each warp works
// on one item, so no state crosses warps and no block-level sync is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 9;
constexpr int kM = 0, kI = 1, kD = 2, kS = 4, kEq = 7, kX = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ bool is_align_match(int c) {
  return c == kM || c == kEq || c == kX;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

__global__ void cleanup_and_compress_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ lens,
    int n_items, int k, int max_out, int32_t* __restrict__ out_codes,
    int32_t* __restrict__ out_lens, int32_t* __restrict__ n_out,
    int32_t* __restrict__ shift_out, uint8_t* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;  // warp-uniform
  const int32_t* c_row = codes + (size_t)item * k;
  const int32_t* l_row = lens + (size_t)item * k;
  int32_t* oc = out_codes + (size_t)item * max_out;
  int32_t* ol = out_lens + (size_t)item * max_out;
  const unsigned lt_mask = (1u << lane) - 1u;
  const unsigned gt_mask = ~((2u << lane) - 1u);  // lane 31: 2u<<31 == 0

  // Pass 1: first and last align-match op (PAD is never an align match).
  int first = k, last = -1;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool am = i < k && is_align_match(c_row[i]);
    const unsigned m = __ballot_sync(kFull, am);
    if (m) {
      if (first == k) first = base + __ffs(m) - 1;
      last = base + 31 - __clz(m);
    }
  }

  // Pass 2: cleanup, then compress, carrying the scan state across chunks.
  int shift = 0;      // sum of leading D lengths
  int prev_code = -1; // code of the previous kept op
  int runs = 0;       // runs started so far
  int ptotal = 0;     // prefix sum of kept lengths before this chunk
  int pend_r = -1;    // the run still open at the chunk boundary
  int pend_p = 0;     // ... and the kept-length prefix at its start
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    int c = kPad, l = 0;
    if (i < k) {
      c = c_row[i];
      l = l_row[i];
    }
    const bool valid = c != kPad;
    const bool lead = i < first;
    const bool edge = (lead || i > last) && valid;
    int sh = (lead && valid && c == kD) ? l : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sh += __shfl_xor_sync(kFull, sh, off);
    shift += sh;
    if (edge && (c == kD || c == kI)) {
      if (c == kD) l = 0;
      c = kS;
    }
    const bool keep = c != kPad && l != 0;
    const unsigned kmask = __ballot_sync(kFull, keep);
    const unsigned lower = kmask & lt_mask;
    int pc = __shfl_sync(kFull, c, lower ? 31 - __clz(lower) : lane);
    if (!lower) pc = prev_code;
    const bool nr = keep && pc != c;
    const unsigned nmask = __ballot_sync(kFull, nr);

    const int v = keep ? l : 0;
    const int incl = warp_inclusive_sum(v, lane);
    const int p_excl = ptotal + incl - v;
    const int r = runs + __popc(nmask & lt_mask);
    const unsigned higher = nmask & gt_mask;
    const int p_next = __shfl_sync(kFull, p_excl, higher ? __ffs(higher) - 1 : lane);
    if (nr && r < max_out) {
      oc[r] = c;
      if (higher) ol[r] = p_next - p_excl;
    }
    if (nmask) {
      // the first run start here closes the run left open by earlier chunks
      const int p_first = __shfl_sync(kFull, p_excl, __ffs(nmask) - 1);
      if (lane == 0 && pend_r >= 0 && pend_r < max_out) ol[pend_r] = p_first - pend_p;
      pend_p = __shfl_sync(kFull, p_excl, 31 - __clz(nmask));
      pend_r = runs + __popc(nmask) - 1;
    }
    runs += __popc(nmask);
    ptotal += __shfl_sync(kFull, incl, 31);
    if (kmask) prev_code = __shfl_sync(kFull, c, 31 - __clz(kmask));
  }
  if (lane == 0 && pend_r >= 0 && pend_r < max_out) ol[pend_r] = ptotal - pend_p;
  const int n_kept = runs < max_out ? runs : max_out;
  for (int r = n_kept + lane; r < max_out; r += 32) {
    oc[r] = kPad;
    ol[r] = 0;
  }
  if (lane == 0) {
    n_out[item] = n_kept;
    shift_out[item] = shift;
    overflow[item] = runs > max_out ? 1 : 0;
  }
}

}  // namespace

extern "C" int ptt_cleanup_and_compress(
    const void* codes, const void* lens, int n_items, int k, int max_out,
    void* out_codes, void* out_lens, void* n_out, void* shift, void* overflow,
    void* stream) {
  if (n_items > 0) {
    const int blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cleanup_and_compress_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<const int32_t*>(lens),
        n_items, k, max_out, static_cast<int32_t*>(out_codes),
        static_cast<int32_t*>(out_lens), static_cast<int32_t*>(n_out),
        static_cast<int32_t*>(shift), static_cast<uint8_t*>(overflow));
  }
  return static_cast<int>(cudaGetLastError());
}
