// Per-window compare of stage 4 (window runs of mixed indel clusters),
// written once for the CUDA kernel (window_match.cu) and for a host build
// with g++ (tests/test_torch_window_match.py compiles this header alone).
//
// A window is a byte source w(t), t in [0, window).  Two windows give
//   leading_run:  the number of leading t with a(t) == b(t);
//   trailing_run: the number of trailing t with a(t) == b(t).
// The byte sources:
//   GenomeWindow      -- the resident genome at a global int64 offset, with
//                        the first superblock clamped to [0, nsb - 2] as
//                        portello_tpu.kernels.resident.fetch_ref_windows_global
//                        does, so every load is inside the genome;
//   PackedReadWindow  -- a packed BAM-nibble read row, base p in byte p >> 1
//                        (high nibble first), byte 0xFD outside the row,
//                        widened through "=ACMGRSVTWYHKDBN";
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

template <class Load>
struct PackedReadWindow {
  Load load;
  int64_t lp;     // packed bytes in the row
  int64_t start;  // base position of t = 0
  PTT_HD PackedReadWindow(Load l, int64_t n, int64_t s)
      : load(l), lp(n), start(s) {}
  PTT_HD int operator()(int t) const {
    const int64_t p = start + t;
    const int64_t k = p >> 1;  // floor, also for negative p
    const int byte = (k >= 0 && k < lp) ? load(k) : 0xFD;
    const int nib = (p & 1) ? (byte & 15) : (byte >> 4);
    return static_cast<uint8_t>("=ACMGRSVTWYHKDBN"[nib]);
  }
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

// Both raw runs of one mixed cluster on the resident path
// (portello_tpu/kernels/simplify_kernel.py:482-502): the trailing run of the
// windows ending at the cluster's ref/read ends, and the leading run of the
// windows starting at its ref/read starts.  bs/dl are relative to g_base,
// rs/il to the read row.
template <class GLoad, class RLoad>
PTT_HD void resident_cluster_runs(GLoad genome, int64_t nsb, int64_t g_base,
                                  RLoad read, int64_t lp, int32_t bs,
                                  int32_t rs, int32_t dl, int32_t il,
                                  int window, int32_t* raw_r, int32_t* raw_l) {
  const int64_t w = window;
  *raw_r = trailing_run(GenomeWindow<GLoad>(genome, nsb, g_base + bs + dl - w),
                        PackedReadWindow<RLoad>(read, lp, int64_t(rs) + il - w),
                        window);
  *raw_l = leading_run(GenomeWindow<GLoad>(genome, nsb, g_base + bs),
                       PackedReadWindow<RLoad>(read, lp, rs), window);
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
