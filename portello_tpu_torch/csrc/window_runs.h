// Per-window compare of stage 4 (window runs of mixed indel clusters),
// written once for the CUDA kernel (window_match.cu) and for a host build
// with g++ (tests/test_torch_window_match.py compiles this header alone).
//
// A window is a byte source w(t), t in [0, window).  Two windows give
//   leading_run:  the number of leading t with a(t) == b(t);
//   trailing_run: the number of trailing t with a(t) == b(t).
// The resident kernel compares all t of a window at once, one or two per
// lane, and gathers the mismatches into a 64-bit mask (bit t set where
// a(t) != b(t)); leading_run_from_mismatch and trailing_run_from_mismatch
// turn that mask into the two runs.  The Pallas-contract kernel walks t one
// by one (leading_run, trailing_run).
// The byte sources:
//   GenomeWindow      -- the resident genome at a global int64 offset, with
//                        the first superblock clamped to [0, nsb - 2] as
//                        portello_tpu.kernels.resident.fetch_ref_windows_global
//                        does, so every load is inside the genome;
//   PackedReadWindow  -- a packed BAM-nibble read row, base p in byte p >> 1
//                        (high nibble first), byte 0xFD outside the row,
//                        widened through "=ACMGRSVTWYHKDBN" (decode_base,
//                        a lookup in two 64-bit words held in registers);
//   PaddedTableWindow -- a (nsb, 128) table of the Pallas window_match
//                        contract (128-byte front pad), with its clamp.
// A Load functor turns an int64 index into a byte; DirectLoad reads through
// the read-only cache on the device.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
#else
#define PTT_HD inline
#endif

namespace ptt {

struct DirectLoad {
  const uint8_t* p;
  PTT_HD int operator()(int64_t i) const {
#if defined(__CUDA_ARCH__)
    return __ldg(p + i);
#else
    return p[i];
#endif
  }
};

PTT_HD int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <class Load>
struct GenomeWindow {
  Load load;
  int64_t first;  // index of byte t = 0
  // q: global byte offset of the window start; nsb: the genome's 64-byte
  // superblocks.
  PTT_HD GenomeWindow(Load l, int64_t nsb, int64_t q)
      : load(l), first((clamp64(q >> 6, 0, nsb - 2) << 6) | (q & 63)) {}
  PTT_HD int operator()(int t) const { return load(first + t); }
};

// "=ACMGRSVTWYHKDBN"[nib], from two 64-bit words (byte i of the pair is
// entry i), so no thread loads a table from memory.
PTT_HD int decode_base(int nib) {
  const uint64_t lo = 0x565352474D43413Dull;  // = A C M G R S V
  const uint64_t hi = 0x4E42444B48595754ull;  // T W Y H K D B N
  return static_cast<int>(((nib & 8 ? hi : lo) >> ((nib & 7) * 8)) & 0xFF);
}

// Base position p of a packed row from the byte that holds it.
PTT_HD int decode_packed(int byte, int64_t p) {
  return decode_base((p & 1) ? (byte & 15) : (byte >> 4));
}

template <class Load>
struct PackedReadWindow {
  Load load;
  int64_t lp;     // packed bytes in the row
  int64_t start;  // base position of t = 0
  PTT_HD PackedReadWindow(Load l, int64_t n, int64_t s)
      : load(l), lp(n), start(s) {}
  // The byte that holds base t; the kernel loads every window's bytes
  // before it decodes any, so no load waits on another's decode.
  PTT_HD int raw(int t) const {
    const int64_t k = (start + t) >> 1;  // floor, also for negative p
    return (k >= 0 && k < lp) ? load(k) : 0xFD;
  }
  PTT_HD int operator()(int t) const { return decode_packed(raw(t), start + t); }
};

template <class Load>
struct PaddedTableWindow {
  Load load;
  int64_t first;
  // start: window start in the unpadded sequence; nsb: 128-byte rows.
  PTT_HD PaddedTableWindow(Load l, int64_t nsb, int64_t start)
      : load(l), first(0) {
    const int64_t p = start + 128;
    first = (clamp64(p >> 7, 0, nsb - 2) << 7) + (p & 127);
  }
  PTT_HD int operator()(int t) const { return load(first + t); }
};

template <class A, class B>
PTT_HD int leading_run(const A& a, const B& b, int window) {
  int t = 0;
  while (t < window && a(t) == b(t)) ++t;
  return t;
}

template <class A, class B>
PTT_HD int trailing_run(const A& a, const B& b, int window) {
  int t = window;
  while (t > 0 && a(t - 1) == b(t - 1)) --t;
  return window - t;
}

// The runs of a window pair from its mismatch mask (bit t set where the
// bytes at t differ; no bit at or above `window`, window <= 64).
PTT_HD int ctz64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __ffsll(static_cast<long long>(x)) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

PTT_HD int clz64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __clzll(static_cast<long long>(x));
#else
  return __builtin_clzll(x);
#endif
}

PTT_HD int leading_run_from_mismatch(uint64_t mismatch, int window) {
  return mismatch ? ctz64(mismatch) : window;
}

PTT_HD int trailing_run_from_mismatch(uint64_t mismatch, int window) {
  return mismatch ? window - 1 - (63 - clz64(mismatch)) : window;
}

// The four windows of one mixed cluster on the resident path
// (portello_tpu/kernels/simplify_kernel.py:482-502): raw_r is the trailing
// run of the ref and read windows ending at the cluster's ref/read ends,
// raw_l the leading run of those starting at its ref/read starts.  bs/dl
// are relative to g_base, rs/il to the read row.
template <class GLoad, class RLoad>
struct ResidentPair {
  GenomeWindow<GLoad> ref_r, ref_l;
  PackedReadWindow<RLoad> read_r, read_l;
  PTT_HD ResidentPair(GLoad genome, int64_t nsb, int64_t g_base, RLoad read,
                      int64_t lp, int32_t bs, int32_t rs, int32_t dl,
                      int32_t il, int window)
      : ref_r(genome, nsb, g_base + bs + dl - window),
        ref_l(genome, nsb, g_base + bs),
        read_r(read, lp, int64_t(rs) + il - window),
        read_l(read, lp, rs) {}
};

// Both raw runs of one mixed cluster from its two mismatch masks.  The
// kernel builds each mask with one ballot per 32 positions; this loop
// builds the same masks one position at a time (the host build's path).
template <class GLoad, class RLoad>
PTT_HD void resident_cluster_runs(GLoad genome, int64_t nsb, int64_t g_base,
                                  RLoad read, int64_t lp, int32_t bs,
                                  int32_t rs, int32_t dl, int32_t il,
                                  int window, int32_t* raw_r, int32_t* raw_l) {
  const ResidentPair<GLoad, RLoad> p(genome, nsb, g_base, read, lp, bs, rs,
                                     dl, il, window);
  uint64_t mis_r = 0, mis_l = 0;
  for (int t = 0; t < window; ++t) {
    mis_r |= uint64_t(p.ref_r(t) != p.read_r(t)) << t;
    mis_l |= uint64_t(p.ref_l(t) != p.read_l(t)) << t;
  }
  *raw_r = trailing_run_from_mismatch(mis_r, window);
  *raw_l = leading_run_from_mismatch(mis_l, window);
}

// Both runs of one (item, cluster) under the Pallas window_match contract
// (portello_tpu/kernels/pallas/window_match.py:60): one pair of windows
// a[ia:ia+W], b[ib:ib+W] on pad_table tables.
template <class Load>
PTT_HD void table_cluster_runs(Load a, Load b, int64_t nsb, int32_t ia,
                               int32_t ib, int window, int32_t* run_fwd,
                               int32_t* run_rev) {
  const PaddedTableWindow<Load> wa(a, nsb, ia), wb(b, nsb, ib);
  *run_fwd = leading_run(wa, wb, window);
  *run_rev = trailing_run(wa, wb, window);
}

}  // namespace ptt
