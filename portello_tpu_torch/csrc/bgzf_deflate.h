// Deflate of one BGZF payload, written once for the CUDA kernel
// (bgzf_deflate.cu) and for a host build with g++ (io/native/ptio.cc, whose
// ptio_bgzf_deflate_plain runs it for the tests).  The two give the same
// bytes: every step below is defined by its result; the kernel runs the
// match search, the CRC and the writing of the bits over many threads, and
// the parse and each deflate block's trees on one.
//
// The format: a raw deflate stream (RFC 1951) of a payload of at most
// kMaxPayload bytes, as a BGZF block carries it, with the payload's CRC32.
// The algorithm: zlib level 6's chain of 128 entries and lazy matching,
// but a search at every position and none of zlib's cuts (the chain of 32
// past a match of 8, no look past 16, a stop at 128); its output is 1.1%
// smaller than zlib level 6's on the benchmark's reads.
//   chains   -- prev[i] is the nearest j < i whose 3 bytes hash as i's do
//               (a 13-bit multiplicative hash of the 24-bit trigram);
//   search   -- at every position, the longest match (3..258 bytes) among
//               the kMaxChain nearest chain entries within 32 KiB (as in
//               zlib, an entry of another trigram under the same hash
//               counts and matches nothing), stopping only at the longest
//               possible; ties go to the nearest; a 3-byte match farther
//               than 4096 bytes is none (zlib's TOO_FAR);
//   parse    -- zlib's lazy evaluation over those matches: a match at i is
//               taken unless the match at i + 1 is longer, always looked
//               at (zlib skips the look at lengths >= 16);
//   blocks   -- a deflate block every kBlockSymbols symbols, as zlib
//               flushes its symbol buffer; each block dynamic, fixed or
//               stored, whichever is fewest bits, ties to stored, then
//               fixed;
//   trees    -- optimal code lengths (Moffat and Katajainen's in-place
//               algorithm over the symbols sorted by count, then symbol),
//               limited to 15 bits (7 for the code-length code) by
//               moving leaves down as miniz does, longest codes to the
//               rarest symbols; a tree with fewer than two used symbols
//               gets symbols 0 and 1 at count 1, as zlib's does;
//   header   -- the literal/length and distance lengths as one sequence,
//               run-length coded with codes 16, 17 and 18.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BGZF_HD __host__ __device__ __forceinline__
#else
#define BGZF_HD inline
#endif

namespace bgzf {

constexpr int kMaxPayload = 65280;  // the writer's block: 0xff00 bytes
constexpr int kOutStride = 65536;   // a stored payload takes kMaxPayload + 5
constexpr int kWindow = 32768;
constexpr int kMaxMatch = 258;
constexpr int kMaxChain = 128;
constexpr int kTooFar = 4096;
constexpr int kHashBits = 13;
constexpr int kBlockSymbols = 16384;
constexpr uint16_t kNil = 0xffff;   // end of a chain; no position is 0xffff
constexpr uint16_t kStart = 0x8000; // parse: a symbol starts here

// ---------------------------------------------------------------- helpers

BGZF_HD int log2_floor(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

BGZF_HD uint32_t reverse_bits(uint32_t code, int len) {
#if defined(__CUDA_ARCH__)
  return __brev(code) >> (32 - len);
#else
  uint32_t r = 0;
  for (int i = 0; i < len; ++i, code >>= 1) r = (r << 1) | (code & 1);
  return r;
#endif
}

BGZF_HD uint32_t hash3(const uint8_t* d, int i) {
  uint32_t v = (uint32_t)d[i] << 16 | (uint32_t)d[i + 1] << 8 | d[i + 2];
  return (v * 2654435761u) >> (32 - kHashBits);
}

// Length code (257..285) of a match length, and its extra bits.
BGZF_HD void length_code(int len, int* code, int* nextra, int* extra) {
  int l = len - 3;
  if (len == kMaxMatch) {
    *code = 285, *nextra = 0, *extra = 0;
  } else if (l < 8) {
    *code = 257 + l, *nextra = 0, *extra = 0;
  } else {
    int e = log2_floor((uint32_t)l) - 2;
    *code = 265 + 4 * (e - 1) + ((l >> e) - 4);
    *nextra = e;
    *extra = l & ((1 << e) - 1);
  }
}

// Distance code (0..29) of a distance less one, and its extra bits.
BGZF_HD void dist_code(int d, int* code, int* nextra, int* extra) {
  if (d < 4) {
    *code = d, *nextra = 0, *extra = 0;
  } else {
    int e = log2_floor((uint32_t)d) - 1;
    *code = 2 * e + 2 + ((d >> e) & 1);
    *nextra = e;
    *extra = d & ((1 << e) - 1);
  }
}

// ----------------------------------------------------------------- CRC32

// zlib's CRC32 (reflected, 0xEDB88320, inverted in and out).
BGZF_HD uint32_t crc_table_entry(uint32_t n) {
  uint32_t c = n;
  for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
  return c;
}

BGZF_HD uint32_t crc32_bytes(const uint32_t* table, const uint8_t* p, int n) {
  uint32_t c = 0xffffffffu;
  for (int i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// a * b modulo the CRC polynomial, reflected (zlib's multmodp).
BGZF_HD uint32_t crc_multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ 0xedb88320u : b >> 1;
  }
  return p;
}

// CRC32 of A followed by B from the CRC32s of both and B's length
// (zlib's crc32_combine): x^(8 len_b) * crc_a + crc_b.
BGZF_HD uint32_t crc32_combine(uint32_t crc_a, uint32_t crc_b, uint32_t len_b) {
  uint32_t x = 1u << 31, base = 1u << 23;  // x^0 and x^8
  for (; len_b; len_b >>= 1) {
    if (len_b & 1) x = crc_multmodp(base, x);
    base = crc_multmodp(base, base);
  }
  return crc_multmodp(x, crc_a) ^ crc_b;
}

// ----------------------------------------------------------------- search

// The longest common prefix of d[a..] and d[b..], at most maxlen bytes.
BGZF_HD int common_prefix(const uint8_t* d, int a, int b, int maxlen) {
  int k = 0;
  while (k < maxlen && d[a + k] == d[b + k]) ++k;
  return k;
}

// The match at position i as (length << 16) | (distance - 1), or 0: the
// longest among the kMaxChain nearest positions j < i, i - j <= kWindow,
// that prev chains with i (nearest first, kNil at the end), at most
// min(kMaxMatch, n - i) bytes long and at least 3; ties to the nearest.
// With `visits`, adds the chain entries it looked at (the search's work).
BGZF_HD uint32_t find_match(const uint8_t* d, int n, const uint16_t* prev,
                            int i, long long* visits = nullptr) {
  if (n - i < 3) return 0;
  int maxlen = n - i < kMaxMatch ? n - i : kMaxMatch;
  int best = 2, best_dist = 0, steps = 0;
  for (uint32_t c = prev[i];
       c != kNil && i - (int)c <= kWindow && steps < kMaxChain;
       c = prev[c], ++steps) {
    if (d[c + best] != d[i + best]) continue;
    int len = common_prefix(d, (int)c, i, maxlen);
    if (len > best) {
      best = len;
      best_dist = i - (int)c;
      if (best == maxlen) {
        ++steps;
        break;
      }
    }
  }
  if (visits) *visits += steps;
  if (best < 3 || (best == 3 && best_dist > kTooFar)) return 0;
  return (uint32_t)best << 16 | (uint32_t)(best_dist - 1);
}

// ------------------------------------------------------------------ parse

// Lazy evaluation over the match lengths in desc[0..n) (0: none).  Leaves
// desc[s] = kStart | 1 at a literal and kStart | L at a match of L bytes;
// the entries a match covers keep what they held.
BGZF_HD void lazy_parse(uint16_t* desc, int n) {
  int prev_len = 0;
  bool pending = false;
  int i = 0;
  while (i < n) {
    int cur = desc[i];
    if (prev_len >= 3 && cur <= prev_len) {
      desc[i - 1] = (uint16_t)(kStart | prev_len);
      i += prev_len - 1;
      prev_len = 0;
      pending = false;
      continue;
    }
    if (pending) desc[i - 1] = kStart | 1;
    prev_len = cur;
    pending = true;
    ++i;
  }
  if (pending) desc[n - 1] = kStart | 1;
}

// A match's start s also holds its distance less one in desc[s + 1], a
// position the match covers (set between lazy_parse and encode).
BGZF_HD bool is_match_start(uint16_t v) {
  return (v & kStart) && (v & 0x7fff) >= 3;
}

// ------------------------------------------------------------------ trees

constexpr int kLitCodes = 286;
constexpr int kDistCodes = 30;
constexpr int kClCodes = 19;
constexpr int kMaxRle = kLitCodes + kDistCodes;

// What one deflate block's trees need; on the card it lives in shared
// memory.
struct Scratch {
  uint32_t lit_freq[kLitCodes];
  uint32_t dist_freq[kDistCodes];
  uint32_t cl_freq[kClCodes];
  uint32_t keys[kLitCodes];
  uint32_t depth[kLitCodes];
  uint16_t lit_code[kLitCodes];
  uint16_t dist_code[kDistCodes];
  uint16_t cl_code[kClCodes];
  uint16_t rle[kMaxRle];  // code-length symbol | extra << 5
  uint8_t lit_len[kLitCodes];
  uint8_t dist_len[kDistCodes];
  uint8_t cl_len[kClCodes];
  uint8_t seq[kMaxRle];
};

// Moffat and Katajainen's in-place minimum-redundancy code: a[0..m) the
// weights in ascending order, m >= 2; on return a[k] is the code length of
// the k-th, non-increasing in k.
BGZF_HD void min_redundancy(uint32_t* a, int m) {
  a[0] += a[1];
  int root = 0, leaf = 2;
  for (int next = 1; next < m - 1; ++next) {
    if (leaf >= m || a[root] < a[leaf]) {
      a[next] = a[root];
      a[root++] = next;
    } else {
      a[next] = a[leaf++];
    }
    if (leaf >= m || (root < next && a[root] < a[leaf])) {
      a[next] += a[root];
      a[root++] = next;
    } else {
      a[next] += a[leaf++];
    }
  }
  a[m - 2] = 0;
  for (int next = m - 3; next >= 0; --next) a[next] = a[a[next]] + 1;
  int avbl = 1, used = 0, dpth = 0;
  int root2 = m - 2, next = m - 1;
  while (avbl > 0) {
    while (root2 >= 0 && (int)a[root2] == dpth) {
      ++used;
      --root2;
    }
    while (avbl > used) {
      a[next--] = dpth;
      --avbl;
    }
    avbl = 2 * used;
    ++dpth;
    used = 0;
  }
}

// Code lengths of at most `limit` bits for freq[0..nsym); keys and depth
// are scratch of nsym entries.
BGZF_HD void build_lengths(const uint32_t* freq, int nsym, int limit,
                           uint8_t* len, uint32_t* keys, uint32_t* depth) {
  int m = 0;
  for (int s = 0; s < nsym; ++s) {
    len[s] = 0;
    if (freq[s]) keys[m++] = freq[s] << 9 | (uint32_t)s;
  }
  for (int s = 0; m < 2; ++s)  // symbols 0 and 1 at count 1, where unused
    if (!freq[s]) keys[m++] = 1u << 9 | (uint32_t)s;
  for (int k = 1; k < m; ++k) {  // insertion sort by (count, symbol)
    uint32_t v = keys[k];
    int j = k - 1;
    while (j >= 0 && keys[j] > v) {
      keys[j + 1] = keys[j];
      --j;
    }
    keys[j + 1] = v;
  }
  for (int k = 0; k < m; ++k) depth[k] = keys[k] >> 9;
  min_redundancy(depth, m);
  int count[33] = {};
  for (int k = 0; k < m; ++k) ++count[depth[k] < 32 ? depth[k] : 32];
  for (int l = limit + 1; l <= 32; ++l) {
    count[limit] += count[l];
    count[l] = 0;
  }
  uint32_t total = 0;
  for (int l = limit; l > 0; --l) total += (uint32_t)count[l] << (limit - l);
  while (total != (1u << limit)) {
    --count[limit];
    for (int l = limit - 1; l > 0; --l)
      if (count[l]) {
        --count[l];
        count[l + 1] += 2;
        break;
      }
    --total;
  }
  int k = m - 1;  // the most frequent first, to the shortest codes
  for (int l = 1; l <= limit; ++l)
    for (int c = count[l]; c > 0; --c) len[keys[k--] & 511] = (uint8_t)l;
}

// Canonical codes, bit-reversed for LSB-first output.
BGZF_HD void build_codes(const uint8_t* len, int nsym, uint16_t* code) {
  int count[16] = {};
  for (int s = 0; s < nsym; ++s) ++count[len[s]];
  count[0] = 0;
  int next[16];
  int c = 0;
  for (int l = 1; l < 16; ++l) {
    c = (c + count[l - 1]) << 1;
    next[l] = c;
  }
  for (int s = 0; s < nsym; ++s)
    code[s] = len[s] ? (uint16_t)reverse_bits((uint32_t)next[len[s]]++, len[s])
                     : 0;
}

BGZF_HD int fixed_lit_len(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

BGZF_HD uint32_t fixed_lit_code(int s) {
  uint32_t c = s < 144   ? 0x30 + s
               : s < 256 ? 0x190 + (s - 144)
               : s < 280 ? (uint32_t)(s - 256)
                         : 0xc0 + (s - 280);
  return reverse_bits(c, fixed_lit_len(s));
}

// ----------------------------------------------------------------- encode
//
// The stream is written in chunks: chunk t holds the positions
// [t chunk, (t + 1) chunk) and the symbols that start there.
// Counting the symbols of each chunk and scanning the counts numbers them,
// which splits them into blocks; each chunk then counts its symbols into
// its blocks' frequencies, the blocks' trees and types fix where each
// block's bits begin, and scanning the chunks' bits places every symbol.
// The bits go in with OR into a zeroed output, so the order of the chunks'
// writes does not matter, nor the chunks' size.  The kernel runs a chunk a
// thread; the plain version runs them one after another.

constexpr int kMaxBlocks = (kMaxPayload + kBlockSymbols - 1) / kBlockSymbols;

BGZF_HD void add_u32(uint32_t* p, uint32_t v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

BGZF_HD void or_u64(unsigned long long* p, unsigned long long v) {
#if defined(__CUDA_ARCH__)
  atomicOr(p, v);
#else
  *p |= v;
#endif
}

// ORs the n <= 57 low bits of `bits` into the LSB-first stream at bit pos.
BGZF_HD void put_bits_at(unsigned long long* out, uint32_t pos,
                         unsigned long long bits, int n) {
  int sh = pos & 63;
  or_u64(&out[pos >> 6], bits << sh);
  if (sh + n > 64) or_u64(&out[(pos >> 6) + 1], bits >> (64 - sh));
}

// The order of the code-length code's lengths in a dynamic header.
BGZF_HD int cl_order(int k) {
  const uint8_t order[kClCodes] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                   11, 4,  12, 3, 13, 2, 14, 1, 15};
  return order[k];
}

// Bits of the block's symbols under the given code lengths (lens of 0
// for the fixed code's literal lengths take fixed_lit_len).
template <bool kFixed>
BGZF_HD uint32_t data_bits(const Scratch* s) {
  uint32_t bits = 0;
  for (int k = 0; k < kLitCodes; ++k) {
    if (!s->lit_freq[k]) continue;
    int l = kFixed ? fixed_lit_len(k) : s->lit_len[k];
    int ne = k < 265 || k == 285 ? 0 : (k - 261) / 4;
    bits += s->lit_freq[k] * (uint32_t)(l + ne);
  }
  for (int k = 0; k < kDistCodes; ++k) {
    if (!s->dist_freq[k]) continue;
    int l = kFixed ? 5 : s->dist_len[k];
    int ne = k < 4 ? 0 : k / 2 - 1;
    bits += s->dist_freq[k] * (uint32_t)(l + ne);
  }
  return bits;
}

// Builds the dynamic trees and the run-length coded header; returns the
// header's bits after the block's 3 and sets *n_rle, *hlit, *hdist,
// *hclen.
BGZF_HD uint32_t build_dynamic(Scratch* s, int* n_rle, int* hlit, int* hdist,
                               int* hclen) {
  build_lengths(s->lit_freq, kLitCodes, 15, s->lit_len, s->keys, s->depth);
  build_lengths(s->dist_freq, kDistCodes, 15, s->dist_len, s->keys, s->depth);
  int hl = kLitCodes, hd = kDistCodes;
  while (hl > 257 && !s->lit_len[hl - 1]) --hl;
  while (hd > 1 && !s->dist_len[hd - 1]) --hd;
  int total = hl + hd;
  for (int k = 0; k < hl; ++k) s->seq[k] = s->lit_len[k];
  for (int k = 0; k < hd; ++k) s->seq[hl + k] = s->dist_len[k];
  for (int k = 0; k < kClCodes; ++k) s->cl_freq[k] = 0;
  int nr = 0;
  for (int i = 0; i < total;) {
    int v = s->seq[i], run = 1;
    while (i + run < total && s->seq[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run >= 11) {
        int r = run < 138 ? run : 138;
        s->rle[nr++] = (uint16_t)(18 | (r - 11) << 5);
        run -= r;
      }
      if (run >= 3) {
        s->rle[nr++] = (uint16_t)(17 | (run - 3) << 5);
        run = 0;
      }
    } else {
      s->rle[nr++] = (uint16_t)v;
      --run;
      while (run >= 3) {
        int r = run < 6 ? run : 6;
        s->rle[nr++] = (uint16_t)(16 | (r - 3) << 5);
        run -= r;
      }
    }
    for (; run > 0; --run) s->rle[nr++] = (uint16_t)v;
  }
  for (int k = 0; k < nr; ++k) ++s->cl_freq[s->rle[k] & 31];
  build_lengths(s->cl_freq, kClCodes, 7, s->cl_len, s->keys, s->depth);
  int hc = kClCodes;
  while (hc > 4 && !s->cl_len[cl_order(hc - 1)]) --hc;
  uint32_t bits = 5 + 5 + 4 + 3 * (uint32_t)hc;
  for (int k = 0; k < nr; ++k) {
    int sym = s->rle[k] & 31;
    bits += s->cl_len[sym] + (sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0);
  }
  *n_rle = nr, *hlit = hl, *hdist = hd, *hclen = hc;
  return bits;
}

// Where each deflate block goes, and its trees.
struct Plan {
  Scratch tree[kMaxBlocks];
  int n_blocks;
  int start[kMaxBlocks + 1];  // first position; start[n_blocks] = n
  int type[kMaxBlocks];       // 0 stored, 1 fixed, 2 dynamic
  uint32_t head[kMaxBlocks];  // bit of the block's 3-bit header
  uint32_t body[kMaxBlocks];  // bit of its first symbol or stored byte
  uint32_t before[kMaxBlocks];  // bits of the earlier blocks' symbols
  uint32_t fixed_bits[kMaxBlocks], dyn_header[kMaxBlocks], dyn_bits[kMaxBlocks];
  int n_rle[kMaxBlocks], hlit[kMaxBlocks], hdist[kMaxBlocks], hclen[kMaxBlocks];
  uint32_t total_bits;
};

BGZF_HD void chunk_range(int n, int t, int chunk, int* lo, int* hi) {
  *lo = t * chunk < n ? t * chunk : n;
  *hi = *lo + chunk < n ? *lo + chunk : n;
}

// Symbols that start in chunk t (the parse flags each with kStart).
BGZF_HD uint32_t chunk_symbols(const uint16_t* desc, int n, int t, int chunk) {
  int lo, hi;
  chunk_range(n, t, chunk, &lo, &hi);
  uint32_t c = 0;
  for (int p = lo; p < hi; ++p) c += desc[p] >> 15;
  return c;
}

// Zeroes the frequencies of the blocks of `symbols` symbols (entries
// k, k + step, ... of them, for k of step threads).
BGZF_HD void plan_clear(Plan* plan, uint32_t symbols, int n, int k, int step) {
  constexpr int kFreqs = kLitCodes + kDistCodes;
  for (int e = k; e < kMaxBlocks * kFreqs; e += step) {
    Scratch* s = &plan->tree[e / kFreqs];
    int f = e % kFreqs;
    if (f < kLitCodes)
      s->lit_freq[f] = 0;
    else
      s->dist_freq[f - kLitCodes] = 0;
  }
  if (k == 0) {
    plan->n_blocks = (int)((symbols + kBlockSymbols - 1) / kBlockSymbols);
    plan->start[plan->n_blocks] = n;
  }
}

// Counts chunk t's symbols, the first numbered sym, into their blocks'
// frequencies; the chunk that holds a block's first symbol records where
// the block starts.
BGZF_HD void chunk_count(const uint8_t* data, const uint16_t* desc, int n,
                         int t, int chunk, uint32_t sym, Plan* plan) {
  int lo, hi;
  chunk_range(n, t, chunk, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    uint16_t v = desc[p];
    if (!(v & kStart)) continue;
    int k = sym / kBlockSymbols;
    if (sym % kBlockSymbols == 0) plan->start[k] = p;
    Scratch* s = &plan->tree[k];
    if (is_match_start(v)) {
      int code, ne, ex;
      length_code(v & 0x7fff, &code, &ne, &ex);
      add_u32(&s->lit_freq[code], 1);
      dist_code(desc[p + 1], &code, &ne, &ex);
      add_u32(&s->dist_freq[code], 1);
    } else {
      add_u32(&s->lit_freq[data[p]], 1);
    }
    ++sym;
  }
}

// Block k's trees and the bits of its symbols under the fixed and the
// dynamic code (end of block not included).
BGZF_HD void plan_block(Plan* plan, int k) {
  Scratch* s = &plan->tree[k];
  s->lit_freq[256] = 1;
  plan->fixed_bits[k] = data_bits<true>(s) - 7;
  plan->dyn_header[k] = build_dynamic(s, &plan->n_rle[k], &plan->hlit[k],
                                      &plan->hdist[k], &plan->hclen[k]);
  plan->dyn_bits[k] = data_bits<false>(s) - s->lit_len[256];
  build_codes(s->lit_len, kLitCodes, s->lit_code);
  build_codes(s->dist_len, kDistCodes, s->dist_code);
  build_codes(s->cl_len, kClCodes, s->cl_code);
}

// Each block's type, the fewest bits (end of block included), ties to
// stored, then fixed, and where its bits go.
BGZF_HD void plan_offsets(Plan* plan) {
  uint32_t pos = 0, before = 0;
  for (int k = 0; k < plan->n_blocks; ++k) {
    const Scratch* s = &plan->tree[k];
    uint32_t len = (uint32_t)(plan->start[k + 1] - plan->start[k]);
    uint32_t pad = (8 - ((pos + 3) & 7)) & 7;
    uint32_t stored = pad + 32 + 8 * len;
    uint32_t fixed = plan->fixed_bits[k] + 7;
    uint32_t dyn = plan->dyn_header[k] + plan->dyn_bits[k] + s->lit_len[256];
    plan->head[k] = pos;
    plan->before[k] = before;
    if (stored <= fixed && stored <= dyn) {
      plan->type[k] = 0;
      plan->body[k] = pos + 3 + pad + 32;
      pos += 3 + stored;
    } else if (fixed <= dyn) {
      plan->type[k] = 1;
      plan->body[k] = pos + 3;
      pos += 3 + fixed;
      before += plan->fixed_bits[k];
    } else {
      plan->type[k] = 2;
      plan->body[k] = pos + 3 + plan->dyn_header[k];
      pos += 3 + dyn;
      before += plan->dyn_bits[k];
    }
  }
  plan->total_bits = plan->n_blocks ? pos : 10;  // n = 0: a fixed EOB
}

// The bits of the symbol at p in block k, and its code: the length or
// literal code then the distance code, with their extra bits, as one
// value of *nbits <= 48 bits.
BGZF_HD unsigned long long symbol_code(const uint8_t* data,
                                       const uint16_t* desc, int p,
                                       const Plan* plan, int k, int* nbits) {
  const Scratch* s = &plan->tree[k];
  bool fixed = plan->type[k] == 1;
  uint16_t v = desc[p];
  if (!is_match_start(v)) {
    int b = data[p];
    *nbits = fixed ? fixed_lit_len(b) : s->lit_len[b];
    return fixed ? fixed_lit_code(b) : s->lit_code[b];
  }
  int code, ne, ex, dc, dne, dex;
  length_code(v & 0x7fff, &code, &ne, &ex);
  dist_code(desc[p + 1], &dc, &dne, &dex);
  int ll = fixed ? fixed_lit_len(code) : s->lit_len[code];
  unsigned long long c = fixed ? fixed_lit_code(code) : s->lit_code[code];
  int dl = fixed ? 5 : s->dist_len[dc];
  unsigned long long d = fixed ? reverse_bits((uint32_t)dc, 5) : s->dist_code[dc];
  c |= (unsigned long long)ex << ll;
  c |= d << (ll + ne);
  c |= (unsigned long long)dex << (ll + ne + dl);
  *nbits = ll + ne + dl + dne;
  return c;
}

// Bits of chunk t's symbols, the first numbered sym (stored blocks' none).
BGZF_HD uint32_t chunk_bits(const uint8_t* data, const uint16_t* desc, int n,
                            int t, int chunk, uint32_t sym, const Plan* plan) {
  int lo, hi, nb;
  chunk_range(n, t, chunk, &lo, &hi);
  uint32_t bits = 0;
  for (int p = lo; p < hi; ++p) {
    if (!(desc[p] & kStart)) continue;
    int k = sym++ / kBlockSymbols;
    if (plan->type[k] == 0) continue;
    symbol_code(data, desc, p, plan, k, &nb);
    bits += nb;
  }
  return bits;
}

// Writes chunk t's symbols; `bits` is the bits of every symbol before it.
BGZF_HD void chunk_write(const uint8_t* data, const uint16_t* desc, int n,
                         int t, int chunk, uint32_t sym, uint32_t bits,
                         const Plan* plan, unsigned long long* out) {
  int lo, hi, nb;
  chunk_range(n, t, chunk, &lo, &hi);
  for (int p = lo; p < hi; ++p) {
    if (!(desc[p] & kStart)) continue;
    int k = sym++ / kBlockSymbols;
    if (plan->type[k] == 0) continue;
    unsigned long long c = symbol_code(data, desc, p, plan, k, &nb);
    put_bits_at(out, plan->body[k] + bits - plan->before[k], c, nb);
    bits += nb;
  }
}

// Writes the blocks' headers, stored lengths and ends of block.
BGZF_HD void write_headers(const Plan* plan, unsigned long long* out) {
  if (!plan->n_blocks) {
    put_bits_at(out, 0, 1 | 1 << 1, 3);  // final, fixed; EOB is 7 zeros
    return;
  }
  for (int k = 0; k < plan->n_blocks; ++k) {
    const Scratch* s = &plan->tree[k];
    uint32_t last = k == plan->n_blocks - 1;
    uint32_t pos = plan->head[k];
    put_bits_at(out, pos, last | (uint32_t)plan->type[k] << 1, 3);
    pos += 3;
    if (plan->type[k] == 0) {
      uint32_t len = (uint32_t)(plan->start[k + 1] - plan->start[k]);
      put_bits_at(out, plan->body[k] - 32, len | (~len & 0xffff) << 16, 32);
    } else if (plan->type[k] == 2) {
      put_bits_at(out, pos, (uint32_t)(plan->hlit[k] - 257), 5);
      put_bits_at(out, pos + 5, (uint32_t)(plan->hdist[k] - 1), 5);
      put_bits_at(out, pos + 10, (uint32_t)(plan->hclen[k] - 4), 4);
      pos += 14;
      for (int c = 0; c < plan->hclen[k]; ++c, pos += 3)
        put_bits_at(out, pos, s->cl_len[cl_order(c)], 3);
      for (int r = 0; r < plan->n_rle[k]; ++r) {
        int sym = s->rle[r] & 31, ex = s->rle[r] >> 5;
        int ne = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
        put_bits_at(out, pos, s->cl_code[sym] | (uint32_t)ex << s->cl_len[sym],
                    s->cl_len[sym] + ne);
        pos += s->cl_len[sym] + ne;
      }
      put_bits_at(out, plan->body[k] + plan->dyn_bits[k], s->lit_code[256],
                  s->lit_len[256]);
    }
  }
}

// The stored blocks' bytes at positions k, k + step, ... (k of step).
BGZF_HD void write_stored(const uint8_t* data, const Plan* plan, int k,
                          int step, unsigned long long* out) {
  for (int b = 0; b < plan->n_blocks; ++b) {
    if (plan->type[b] != 0) continue;
    for (int p = plan->start[b] + k; p < plan->start[b + 1]; p += step)
      put_bits_at(out, plan->body[b] + 8 * (uint32_t)(p - plan->start[b]),
                  data[p], 8);
  }
}

// ------------------------------------------------------------- card entry

// The staging a level-6 BGZF writer hands the card (ptio.cc's codec
// thread): two sets of pinned host buffers, each of max_blocks payloads at
// kMaxPayload bytes apart in `in` and their deflate streams kOutStride
// bytes apart in `out`.  submit deflates the first n payloads of a set on
// the card, asynchronously on the card's own stream; wait blocks until
// that set's out, out_len and crc hold the results.  Both return 0 or a
// CUDA error.  The kernel library allocates one per writer and keeps it
// for the process (bgzf_deflate.cu).
struct CardSet {
  uint8_t* in;
  int32_t* in_len;
  uint8_t* out;
  int32_t* out_len;
  uint32_t* crc;
};

struct Card {
  int (*submit)(Card* card, int set, int n);
  int (*wait)(Card* card, int set);
  CardSet set[2];
  int max_blocks;
  void* impl;
};

}  // namespace bgzf
