// The per-lane arithmetic of kernel 1 (edge-indel cleanup + CIGAR compress),
// written once for the CUDA kernel (compress.cu) and for a host build with
// g++ (tests/test_torch_compress_scan.py compiles this header alone and runs
// it on emulated lanes).
//
// An item's K ops are cut into one contiguous segment per lane.  Each lane
//   1. finds the first and last align-match op of its segment (the item's
//      are the min and max over lanes);
//   2. cleans up its ops (clean_op) and folds them, in order, into a
//      RunSummary (summary_push): run count, first and last kept code, the
//      kept length of the last run, the leading-D shift;
//   3. gets the summary of every op before its segment from an exclusive
//      scan of the lanes' summaries under combine(), which is associative;
//   4. walks its segment again with an Emitter started from that prefix:
//      it writes the code of every run that starts in the segment and the
//      length of every run that ends there.  The item's last run ends at the
//      row's end: its length is the total summary's tail.
// This is exactly cigar_kernels.cleanup_and_compress_plain: a kept op is
// one that is not PAD and has a nonzero length after the cleanup; a run is a
// maximal sequence of kept ops with one code, so it merges across dropped
// ops; lengths add in uint32, so they wrap as the plain version's int32
// prefix sums do, with no 2^16 limit.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
#else
#define PTT_HD inline
#endif

namespace ptt {

constexpr int kPad = 9;
constexpr int kM = 0, kI = 1, kD = 2, kS = 4, kEq = 7, kX = 8;

PTT_HD bool is_align_match(int c) { return c == kM || c == kEq || c == kX; }

// Edge cleanup of op i (clean_up_edge_indels): a D or I before the first
// or after the last align match becomes S, a D with length 0; *shift gets
// the length of a leading D.  first = K and last = -1 when the item has no
// align match.
//
// This and the functions below select rather than branch: the lanes of a
// warp take different sides, and on the card a branch per op costs more
// than the op.
PTT_HD void clean_op(int i, int first, int last, int* code, int* len,
                     uint32_t* shift) {
  const int c = *code;
  const bool valid = c != kPad;
  const bool lead = i < first;
  const bool edge_indel = (lead || i > last) && valid && (c == kD || c == kI);
  *shift = (lead && valid && c == kD) ? static_cast<uint32_t>(*len) : 0u;
  *len = (edge_indel && c == kD) ? 0 : *len;
  *code = edge_indel ? kS : c;
}

PTT_HD bool kept(int code, int len) { return code != kPad && len != 0; }

// The compress state of a run of cleaned ops.
struct RunSummary {
  int runs;        // run starts, the first kept op included (0: none kept)
  int first_code;  // code of the first kept op
  int last_code;   // code of the last kept op
  uint32_t tail;   // kept length of the last run (all of it when runs == 1)
  uint32_t shift;  // sum of leading-D lengths (cleanup)
};

PTT_HD RunSummary empty_summary() { return RunSummary{0, 0, 0, 0u, 0u}; }

// Fold one cleaned op into the summary of the ops before it.
PTT_HD void summary_push(RunSummary* s, int code, int len, uint32_t shift) {
  const uint32_t l = static_cast<uint32_t>(len);
  const bool k = kept(code, len);
  const bool start = k && (s->runs == 0 || code != s->last_code);
  s->shift += shift;
  s->first_code = (k && s->runs == 0) ? code : s->first_code;
  s->tail = start ? l : (k ? s->tail + l : s->tail);
  s->runs += start ? 1 : 0;
  s->last_code = k ? code : s->last_code;
}

// The summary of a's ops followed by b's.
PTT_HD RunSummary combine(const RunSummary& a, const RunSummary& b) {
  const bool merge = a.runs && b.runs && a.last_code == b.first_code;
  const uint32_t tail =
      b.runs == 0 ? a.tail : ((merge && b.runs == 1) ? a.tail + b.tail : b.tail);
  return RunSummary{a.runs + b.runs - (merge ? 1 : 0),
                    a.runs ? a.first_code : b.first_code,
                    b.runs ? b.last_code : a.last_code, tail,
                    a.shift + b.shift};
}

// Pack the scan fields a lane exchanges as one word: runs (< 2^23), first
// and last code (4 bits each).
PTT_HD uint32_t pack_codes(const RunSummary& s) {
  return (static_cast<uint32_t>(s.runs) << 8) |
         (static_cast<uint32_t>(s.first_code) << 4) |
         static_cast<uint32_t>(s.last_code);
}

PTT_HD RunSummary unpack_summary(uint32_t packed, uint32_t tail,
                                 uint32_t shift) {
  return RunSummary{static_cast<int>(packed >> 8),
                    static_cast<int>((packed >> 4) & 15u),
                    static_cast<int>(packed & 15u), tail, shift};
}

// Writes the runs of one lane's segment, given the summary of every op
// before it.  Out has code(r, c) and len(r, l) for r < max_out.
struct Emitter {
  int r;          // index of the open run (-1: none yet)
  int prev_code;  // its code
  uint32_t acc;   // its kept length so far
  PTT_HD explicit Emitter(const RunSummary& before)
      : r(before.runs - 1),
        prev_code(before.runs ? before.last_code : -1),
        acc(before.tail) {}
  template <class Out>
  PTT_HD void push(int code, int len, int max_out, Out& out) {
    const uint32_t l = static_cast<uint32_t>(len);
    const bool k = kept(code, len);
    const bool start = k && code != prev_code;
    if (start && r >= 0 && r < max_out) out.len(r, static_cast<int32_t>(acc));
    r += start ? 1 : 0;
    if (start && r < max_out) out.code(r, code);
    acc = start ? l : (k ? acc + l : acc);
    prev_code = start ? code : prev_code;
  }
};

// The ops per lane when an item's k ops are cut over `lanes` lanes: lane t
// owns [t * len, (t + 1) * len).  The length is rounded up to odd, so lanes
// reading their segments from shared memory in step hit distinct banks.
PTT_HD int segment_len(int k, int lanes) { return ((k + lanes - 1) / lanes) | 1; }

}  // namespace ptt
