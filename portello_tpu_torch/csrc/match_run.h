// Per-pair body of the match_run kernel (match_run.cu), written once for
// the CUDA kernel and for a host build with g++
// (tests/test_torch_match_run.py compiles this header alone).
//
// One pair compares two byte rows a (len_a bytes) and b (len_b bytes) from
// starts ia and ib, forward (a[ia + t] == b[ib + t]) or backward
// (a[ia - 1 - t] == b[ib - 1 - t]), and its run is the number of leading t
// in [0, lim) that compare equal, lim = clamp(limit, 0, window).  A
// position outside [0, len) reads 0xFE on a and 0xFD on b; in-row zero
// padding compares as data.
//
// No load waits on a compare.  The positions of a chunk of at most 64 t
// lie in one 64-byte span per row (forward [i + base, i + base + 64),
// backward [i - base - 64, i - base)), which touches at most five 16-byte
// aligned granules.  Every granule that holds a compared byte of the row is
// loaded first, as one vector load each (SpanRow); then the words of the
// two spans compare in order of t, each realigned from the granules in
// registers only when it is reached (two selects and a funnel shift), and
// the first that differs gives the run.  A span that reaches outside its
// row has each such byte replaced by its side's fill before the compare.
// A window above 64 takes its next chunk only while the previous one
// matched in full and the limit reaches past it.
//
// The CUDA intrinsics each have a host twin under __CUDA_ARCH__.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
// Full unrolls keep the granules in registers; g++ has no such pragma.
#define PTT_UNROLL _Pragma("unroll")
#else
#define PTT_HD inline
#define PTT_UNROLL
#endif

namespace ptt {

constexpr uint32_t kFillA4 = 0xFEFEFEFEu;  // kFillA in every byte
constexpr uint32_t kFillB4 = 0xFDFDFDFDu;  // kFillB in every byte
constexpr int kChunk = 64;                 // positions per span

// 0xFF in each byte where a's unsigned byte is >= b's.
PTT_HD uint32_t vcmpgeu4(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vcmpgeu4(a, b);
#else
  uint32_t r = 0;
  for (int i = 0; i < 32; i += 8)
    if (((a >> i) & 0xFF) >= ((b >> i) & 0xFF)) r |= 0xFFu << i;
  return r;
#endif
}

// 0xFF in each byte where a's unsigned byte is < b's.
PTT_HD uint32_t vcmpltu4(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vcmpltu4(a, b);
#else
  uint32_t r = 0;
  for (int i = 0; i < 32; i += 8)
    if (((a >> i) & 0xFF) < ((b >> i) & 0xFF)) r |= 0xFFu << i;
  return r;
#endif
}

// The low word of (hi:lo) >> shift, shift in [0, 32).
PTT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int shift) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, shift);
#else
  return static_cast<uint32_t>(((uint64_t(hi) << 32) | lo) >> (shift & 31));
#endif
}

// The 16 bytes at a 16-byte aligned address, as four little-endian words.
// A vector load from an unaligned address faults on the device; the host
// twin reads the aligned granule below it instead, so that a misaligned
// load gives wrong runs on the host too.
PTT_HD void load_granule(const uint8_t* p, uint32_t* w) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
#else
  std::memcpy(w, p - (reinterpret_cast<uintptr_t>(p) & 15), 16);
#endif
}

PTT_HD int ctz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}

PTT_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz(static_cast<int>(x));
#else
  return __builtin_clz(x);
#endif
}

PTT_HD int64_t clamp_span(int64_t v) {
  return v < 0 ? 0 : (v > kChunk ? kChunk : v);
}

// The 64-byte span [s, s + 64) of a row (s any int64), of which only the
// bytes [need_lo, need_hi) are compared.  The constructor loads, as one
// vector load each, every aligned granule that holds a byte of both those
// and the row; nothing after it loads.  word(q) is span bytes [4q, 4q + 4)
// (little-endian), realigned on demand from the granules: a word shift of
// o / 4 by two selects, then a funnel shift of o % 4 bytes, o the span's
// offset from a 16-byte boundary.  filled(q) is word(q) with each byte
// outside [0, len) replaced by the fill; `partial` says whether any byte
// of [need_lo, need_hi) lies outside.
struct SpanRow {
  uint32_t g[20];  // granules 0-4 from the aligned address below s
  bool p1, p2;     // bits 0 and 1 of the word shift
  int shift;       // byte shift in bits
  bool partial;
  uint32_t lo4, hi4, fill4;  // in-row span bytes [lo, hi) in every byte

  PTT_HD SpanRow(const uint8_t* row, int64_t len, int64_t s, int need_lo,
                 int need_hi, uint32_t fill) : fill4(fill) {
    // align the address itself: a row starts 16-byte aligned only when the
    // row length is a multiple of 16
    const int o = static_cast<int>(
        (reinterpret_cast<uintptr_t>(row) + static_cast<uint64_t>(s)) & 15);
    const int64_t r0 = s - o;  // row offset of granule 0
    PTT_UNROLL
    for (int k = 0; k < 5; ++k) {
      const int64_t r = r0 + 16 * k;
      if (16 * k + 16 > o + need_lo && 16 * k < o + need_hi && r < len &&
          r + 16 > 0) {
        load_granule(row + r, g + 4 * k);
      } else {
        PTT_UNROLL
        for (int j = 0; j < 4; ++j) g[4 * k + j] = fill;
      }
    }
    p1 = (o >> 2) & 1;
    p2 = (o >> 3) & 1;
    shift = (o & 3) * 8;
    const int64_t lo = clamp_span(-s), hi = clamp_span(len - s);
    partial = lo > need_lo || hi < need_hi;
    lo4 = static_cast<uint32_t>(lo) * 0x01010101u;
    hi4 = static_cast<uint32_t>(hi) * 0x01010101u;
  }
  PTT_HD uint32_t s1(int i) const { return p1 ? g[i + 1] : g[i]; }
  PTT_HD uint32_t s2(int i) const { return p2 ? s1(i + 2) : s1(i); }
  PTT_HD uint32_t word(int q) const {
    return funnel_r(s2(q), s2(q + 1), shift);
  }
  PTT_HD uint32_t filled(int q) const {
    const uint32_t idx = 0x03020100u + 0x04040404u * q;  // span byte indices
    const uint32_t in = vcmpgeu4(idx, lo4) & vcmpltu4(idx, hi4);
    return (word(q) & in) | (fill4 & ~in);
  }
};

// The run of one 64-position chunk: forward, the leading equal bytes of
// spans a and b (n of them compared); backward, the trailing ones, the
// spans ending at the chunk's first position.  Words compare in order and
// stop at the first that differs, so a short run realigns a word or two.
template <bool kRev, bool kFill>
PTT_HD int chunk_run(const SpanRow& a, const SpanRow& b, int n) {
  PTT_UNROLL
  for (int i = 0; i < 16; ++i) {
    if (4 * i >= n) break;
    const int q = kRev ? 15 - i : i;
    const uint32_t x = kFill ? a.filled(q) ^ b.filled(q) : a.word(q) ^ b.word(q);
    if (x) {
      const int r = kRev ? 4 * i + (clz32(x) >> 3) : 4 * i + (ctz32(x) >> 3);
      return r < n ? r : n;
    }
  }
  return n;
}

// The run of one pair whose limit is already clamped to [0, window].
template <bool kRev>
PTT_HD int match_run_pair(const uint8_t* ra, int64_t len_a, const uint8_t* rb,
                          int64_t len_b, int64_t ia, int64_t ib, int lim) {
  int run = 0;
  while (run < lim) {
    const int n = lim - run < kChunk ? lim - run : kChunk;
    // forward: span from the chunk's first position, bytes [0, n) compared;
    // backward: span ending there, bytes [64 - n, 64)
    const int need_lo = kRev ? kChunk - n : 0, need_hi = kRev ? kChunk : n;
    const SpanRow a(ra, len_a, kRev ? ia - run - kChunk : ia + run, need_lo,
                    need_hi, kFillA4);
    const SpanRow b(rb, len_b, kRev ? ib - run - kChunk : ib + run, need_lo,
                    need_hi, kFillB4);
    const int r = a.partial || b.partial ? chunk_run<kRev, true>(a, b, n)
                                         : chunk_run<kRev, false>(a, b, n);
    run += r;
    if (r < n) break;
  }
  return run;
}

// The run of pair (ia, ib, limit) on rows ra and rb, as the kernel computes
// it per thread.  The clamped limit is tested here, not only by the loop:
// see "limit tested by the loop alone" in scripts/torch_kernel_ablations.py.
template <bool kRev>
PTT_HD int32_t match_run_one(const uint8_t* ra, int64_t len_a,
                             const uint8_t* rb, int64_t len_b, int32_t ia,
                             int32_t ib, int32_t limit, int window) {
  const int lim = limit < 0 ? 0 : (limit > window ? window : limit);
  return lim > 0 ? match_run_pair<kRev>(ra, len_a, rb, len_b, ia, ib, lim) : 0;
}

}  // namespace ptt
