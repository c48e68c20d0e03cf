// ptscan: native (C++) phase-2 read scanner for portello-tpu.
//
// The runtime around the JAX device engine: streams the read-to-assembly
// BAM, parses split reads, preps padded device work-item batches, finishes
// lifted records (tags, flags, SA regeneration, primary selection), and
// writes the output BAMs — the role the reference runs across all CPU cores
// (reference src/read_alignment_scanner.rs:369-661, worker_thread_data.rs)
// and round 1 ran in Python at ~1k reads/s.
//
// Python (pipeline/native_feed.py) drives the batch loop:
//     while ptscan_next_batch(h, &desc):  # C++ scans + preps until a batch fills
//         results = jax_device_compute(desc)
//         ptscan_post_results(h, results)  # C++ finishes + writes resolved reads
//
// Exact-semantics ports (conformance enforced by tests/test_native_feed.py
// byte-comparing CLI output against the Python engine path):
//   - split-read/SA parsing: pipeline/split_read.py (reference
//     bam_utils/split_read.rs:56-155, sa_tag_parser.rs:25-59)
//   - item prep: models/pipeline_model.DeviceEngine._prep_item
//   - record finish: pipeline/read_scan.py finish_lifted_record /
//     finish_remapped_alignment_set (reference read_alignment_scanner.rs:245-366)
//   - host-fallback compute: ops/{liftover,simplify,shift,homology}.py via
//     the included ptcore.cc (reference liftover_read_alignment.rs:35-223,
//     simplify_alignment_indels.rs:4-156, shift_indels/, indel_breakend_homology.rs)
//   - unmapped-record semantics: unplaced (tid < 0) records pass through to
//     the unassembled output; placed-unmapped records are a hard error, the
//     reference's assert (read_alignment_scanner.rs:396,537-559).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC ptscan.cc -o ptscan.so -lz -lpthread

#include "ptio.cc"
#include "ptcore.cc"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <stdexcept>
#include <thread>

namespace {

using Cig = std::vector<Op>;  // Op from ptcore.cc: {int32 code, int64 len}

constexpr int kFUNMAP = 0x4, kFREVERSE = 0x10, kFSUPPL = 0x800;

// ---- sequence coding (io/bam.py SEQ_CHARS; ops/seq.py complement LUT) ----

const char kSeqChars[17] = "=ACMGRSVTWYHKDBN";

struct SeqLuts {
  uint8_t comp[256];
  uint8_t enc[256];
  uint8_t enc_comp[256];  // enc[comp[b]]: one lookup in the rev-pack loop
  // Pair tables: one lookup packs two bases (the per-base pack was the
  // finisher's hottest loop at long reads; real inputs hit ~25 distinct
  // indices, so the 64K tables are effectively a handful of cache lines).
  uint8_t enc2[65536];    // idx = s[i] | s[i+1]<<8
  uint8_t enc2c[65536];   // idx = s[-i-1] | s[-i]<<8 (flipped walk)
  uint8_t dec2[256][2];   // packed byte -> both ASCII chars
  uint8_t dec2rc[256][2];  // packed byte -> both revcomp ASCII chars, swapped
  uint8_t rcpack[256];     // packed byte -> revcomp packed byte (nib swap)
  uint8_t code_comp[16];   // nibble code -> complement nibble code
  uint8_t code_comp_ascii[16];  // nibble code -> complement ASCII char
  SeqLuts() {
    for (int i = 0; i < 256; ++i) comp[i] = 'N';
    const char* pairs = "ATCGGCTANN";
    for (int i = 0; i < 5; ++i) {
      uint8_t a = pairs[2 * i], b = pairs[2 * i + 1];
      comp[a] = b;
      comp[a + 32] = b + 32;  // lowercase preserves case
    }
    for (int i = 0; i < 256; ++i) enc[i] = 15;
    for (int i = 0; i < 16; ++i) {
      enc[(uint8_t)kSeqChars[i]] = i;
      enc[(uint8_t)std::tolower(kSeqChars[i])] = i;
    }
    for (int i = 0; i < 256; ++i) enc_comp[i] = enc[comp[i]];
    for (int c = 0; c < 16; ++c) {
      code_comp_ascii[c] = comp[(uint8_t)kSeqChars[c]];
      code_comp[c] = enc[code_comp_ascii[c]];
    }
    for (int v = 0; v < 65536; ++v) {
      uint8_t lo = (uint8_t)(v & 0xFF), hi = (uint8_t)(v >> 8);
      enc2[v] = (uint8_t)((enc[lo] << 4) | enc[hi]);
      enc2c[v] = (uint8_t)((enc_comp[hi] << 4) | enc_comp[lo]);
    }
    for (int b = 0; b < 256; ++b) {
      dec2[b][0] = (uint8_t)kSeqChars[b >> 4];
      dec2[b][1] = (uint8_t)kSeqChars[b & 0xF];
      // reverse-complement pair tables: when walking the packed stream
      // backwards one output unit covers exactly one input byte with its
      // nibbles swapped (even-length fast path; odd lengths peel the head
      // nibble first) — out chars are comp(lo), comp(hi)
      dec2rc[b][0] = code_comp_ascii[b & 0xF];
      dec2rc[b][1] = code_comp_ascii[b >> 4];
      rcpack[b] = (uint8_t)((code_comp[b & 0xF] << 4) | code_comp[b >> 4]);
    }
  }
};
const SeqLuts kLut;

// ---- SIMD (AVX2) nibble codecs -----------------------------------------
// The fill's seq decode and the finisher's flip re-pack walked packed BAM
// nibbles one byte at a time through pair LUTs; a 16-entry pshufb LUT is
// the native form of that table and processes 32 packed bytes (64 bases)
// per iteration.  Scalar forms remain as the tail handler, the short-input
// path, and the non-x86 fallback; outputs are byte-identical
// (tests/test_simd_codecs.py fuzzes all lengths against the scalar walk).
#if defined(__x86_64__) && defined(__GNUC__)
#define PTSCAN_X86 1
#include <immintrin.h>

bool have_avx2() {
  static const bool v = [] {
    const char* e = std::getenv("PTPU_SIMD");
    if (e && e[0] == '0') return false;
    __builtin_cpu_init();
    return __builtin_cpu_supports("avx2") != 0;
  }();
  return v;
}

// 32 packed bytes -> 64 ASCII chars per iteration: out[2j] = chars[in>>4],
// out[2j+1] = chars[in&0xF].
__attribute__((target("avx2")))
void decode_seq_avx2(const uint8_t* packed, int64_t n2, uint8_t* dst) {
  const __m256i lut = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)kSeqChars));
  const __m256i m0f = _mm256_set1_epi8(0x0F);
  int64_t j = 0;
  for (; j + 32 <= n2; j += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(packed + j));
    __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f);
    __m256i lo = _mm256_and_si256(v, m0f);
    __m256i ch = _mm256_shuffle_epi8(lut, hi);
    __m256i cl = _mm256_shuffle_epi8(lut, lo);
    // unpack interleaves per 128-bit lane; permute2x128 restores byte order
    __m256i il = _mm256_unpacklo_epi8(ch, cl);
    __m256i ih = _mm256_unpackhi_epi8(ch, cl);
    _mm256_storeu_si256((__m256i*)(dst + 2 * j),
                        _mm256_permute2x128_si256(il, ih, 0x20));
    _mm256_storeu_si256((__m256i*)(dst + 2 * j + 32),
                        _mm256_permute2x128_si256(il, ih, 0x31));
  }
  for (; j < n2; ++j) std::memcpy(dst + 2 * (size_t)j, kLut.dec2[packed[j]], 2);
}

// full 32-byte reverse: per-lane pshufb reverse + lane swap
__attribute__((target("avx2")))
inline __m256i reverse_bytes_avx2(__m256i v) {
  const __m256i rev = _mm256_setr_epi8(
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0,
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
  v = _mm256_shuffle_epi8(v, rev);
  return _mm256_permute2x128_si256(v, v, 0x01);
}

// n_pairs reverse-complement pairs: out[2k] = comp_ascii[src0[-k] & 0xF],
// out[2k+1] = comp_ascii[src0[-k] >> 4], walking src0 DOWN.  All vector
// loads stay inside packed[src0 - n_pairs + 1 .. src0].
__attribute__((target("avx2")))
void decode_rc_avx2(const uint8_t* src0, int64_t n_pairs, uint8_t* dst) {
  const __m256i lut = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)kLut.code_comp_ascii));
  const __m256i m0f = _mm256_set1_epi8(0x0F);
  int64_t k = 0;
  for (; k + 32 <= n_pairs; k += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src0 - k - 31));
    v = reverse_bytes_avx2(v);
    __m256i lo = _mm256_and_si256(v, m0f);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f);
    __m256i cl = _mm256_shuffle_epi8(lut, lo);
    __m256i ch = _mm256_shuffle_epi8(lut, hi);
    __m256i il = _mm256_unpacklo_epi8(cl, ch);
    __m256i ih = _mm256_unpackhi_epi8(cl, ch);
    _mm256_storeu_si256((__m256i*)(dst + 2 * k),
                        _mm256_permute2x128_si256(il, ih, 0x20));
    _mm256_storeu_si256((__m256i*)(dst + 2 * k + 32),
                        _mm256_permute2x128_si256(il, ih, 0x31));
  }
  for (; k < n_pairs; ++k)
    std::memcpy(dst + 2 * (size_t)k, kLut.dec2rc[src0[-k]], 2);
}

// n re-packed bytes: dst[k] = rcpack[src0[-k]] (nibble swap + complement),
// walking src0 DOWN — the even-length finisher flip path.
__attribute__((target("avx2")))
void rcpack_avx2(const uint8_t* src0, int64_t n, uint8_t* dst) {
  const __m256i lut = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)kLut.code_comp));
  const __m256i m0f = _mm256_set1_epi8(0x0F);
  const __m256i mf0 = _mm256_set1_epi8((char)0xF0);
  int64_t k = 0;
  for (; k + 32 <= n; k += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src0 - k - 31));
    v = reverse_bytes_avx2(v);
    __m256i lo = _mm256_and_si256(v, m0f);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f);
    __m256i cl = _mm256_shuffle_epi8(lut, lo);
    __m256i ch = _mm256_shuffle_epi8(lut, hi);
    __m256i out = _mm256_or_si256(
        _mm256_and_si256(_mm256_slli_epi16(cl, 4), mf0), ch);
    _mm256_storeu_si256((__m256i*)(dst + k), out);
  }
  for (; k < n; ++k) dst[k] = kLut.rcpack[src0[-k]];
}
#else
inline bool have_avx2() { return false; }
#endif

// ---- cigar helpers (ops/cigar.py) ----

int64_t cig_ref_span(const Cig& c) {
  int64_t s = 0;
  for (const Op& o : c)
    if (consumes_ref(o.code)) s += o.len;
  return s;
}

int64_t cig_read_len_hard(const Cig& c) {
  int64_t s = 0;
  for (const Op& o : c)
    if (consumes_read_hard(o.code)) s += o.len;
  return s;
}

bool cig_has_aligned(const Cig& c) {
  for (const Op& o : c)
    if (is_align_match(o.code)) return true;
  return false;
}

// get_read_clip_positions(cig, ignore_hard_clip=False) (cigar/mod.rs:85-118)
void cig_clip_positions(const Cig& c, int64_t* left, int64_t* right_start,
                        int64_t* read_len) {
  int64_t rl = cig_read_len_hard(c);
  *read_len = rl;
  if (c.empty()) {
    *left = 0;
    *right_start = 0;
    return;
  }
  size_t first_nonclip = c.size();
  for (size_t i = 0; i < c.size(); ++i) {
    if (!(c[i].code == kS || c[i].code == kH)) {
      first_nonclip = i;
      break;
    }
  }
  int64_t lc = 0, rc = 0;
  for (size_t i = 0; i < c.size(); ++i) {
    if (c[i].code == kS || c[i].code == kH) {
      if (i < first_nonclip)
        lc += c[i].len;
      else
        rc += c[i].len;
    }
  }
  *left = lc;
  *right_start = rl - rc;
}

std::string cig_to_string(const Cig& c) {
  static const char* chars = "MIDNSHP=X";
  std::string out;
  if (c.empty()) return "*";
  char buf[32];
  for (const Op& o : c) {
    int n = snprintf(buf, sizeof buf, "%lld%c", (long long)o.len,
                     chars[o.code]);
    out.append(buf, n);
  }
  return out;
}

// (homology_left + left_shift_indels_native live in ptcore.cc — shared with
// the standalone ptcore.so for baseline/host-shift measurement.)

// ---- raw BAM record view ----

struct RecView {
  int32_t tid, pos, mtid, mpos, tlen, l_seq;
  uint16_t flag, n_cigar;
  uint8_t mapq;
  std::string qname;
  Cig cigar;
  size_t tags_off;  // into raw
  const uint8_t* raw;
  size_t raw_len;
  bool cg_long = false;  // cigar came from a CG tag
};

// Walk one aux tag; returns offset past it (or raw_len on malformed end).
size_t tag_skip(const uint8_t* p, size_t off, size_t end, std::string* err) {
  if (off + 3 > end) {
    *err = "truncated aux tag";
    return end;
  }
  uint8_t ty = p[off + 2];
  size_t o = off + 3;
  auto scalar = [&](size_t n) { o += n; };
  switch (ty) {
    case 'A': case 'c': case 'C': scalar(1); break;
    case 's': case 'S': scalar(2); break;
    case 'i': case 'I': case 'f': scalar(4); break;
    case 'Z': case 'H':
      while (o < end && p[o]) ++o;
      ++o;
      break;
    case 'B': {
      if (o + 5 > end) {
        *err = "truncated B tag";
        return end;
      }
      uint8_t sub = p[o];
      int32_t cnt;
      std::memcpy(&cnt, p + o + 1, 4);
      size_t esz = (sub == 'c' || sub == 'C') ? 1
                   : (sub == 's' || sub == 'S') ? 2
                                                : 4;
      o += 5 + (size_t)cnt * esz;
      break;
    }
    default:
      *err = "unknown aux type";
      return end;
  }
  return o;
}

bool find_tag(const uint8_t* p, size_t off, size_t end, const char* tag,
              size_t* val_off, uint8_t* ty, std::string* err) {
  while (off + 3 <= end) {
    uint8_t t0 = p[off], t1 = p[off + 1];
    size_t nxt = tag_skip(p, off, end, err);
    if (!err->empty()) return false;
    if (t0 == (uint8_t)tag[0] && t1 == (uint8_t)tag[1]) {
      *val_off = off + 3;
      *ty = p[off + 2];
      return true;
    }
    off = nxt;
  }
  return false;
}

bool parse_record(const uint8_t* raw, size_t n, RecView* rv, std::string* err) {
  if (n < 32) {
    *err = "truncated BAM record";
    return false;
  }
  std::memcpy(&rv->tid, raw + 0, 4);
  std::memcpy(&rv->pos, raw + 4, 4);
  uint8_t l_read_name = raw[8];
  rv->mapq = raw[9];
  std::memcpy(&rv->n_cigar, raw + 12, 2);
  std::memcpy(&rv->flag, raw + 14, 2);
  std::memcpy(&rv->l_seq, raw + 16, 4);
  std::memcpy(&rv->mtid, raw + 20, 4);
  std::memcpy(&rv->mpos, raw + 24, 4);
  std::memcpy(&rv->tlen, raw + 28, 4);
  // validate record-internal lengths against the record size BEFORE any
  // dereference: a corrupt l_seq/n_cigar would read far past the buffer
  // (the Python decode raises a clean error for the same input)
  if (rv->l_seq < 0 ||
      32 + (size_t)l_read_name + 4 * (size_t)rv->n_cigar +
              ((size_t)rv->l_seq + 1) / 2 + (size_t)rv->l_seq >
          n) {
    *err = "corrupt BAM record (field lengths exceed record size)";
    return false;
  }
  size_t off = 32;
  rv->qname.assign((const char*)raw + off, l_read_name ? l_read_name - 1 : 0);
  off += l_read_name;
  rv->cigar.clear();
  rv->cigar.reserve(rv->n_cigar);
  for (int i = 0; i < rv->n_cigar; ++i) {
    uint32_t u;
    std::memcpy(&u, raw + off + 4 * i, 4);
    rv->cigar.push_back({(int32_t)(u & 0xF), (int64_t)(u >> 4)});
  }
  off += 4 * (size_t)rv->n_cigar;
  off += (rv->l_seq + 1) / 2;  // packed seq
  off += rv->l_seq;            // qual
  rv->tags_off = off;
  rv->raw = raw;
  rv->raw_len = n;
  rv->cg_long = false;
  // Long-CIGAR placeholder kSmN + CG:B,I (SAM spec 4.2.2; io/bam.py decode)
  if (rv->n_cigar == 2 && rv->cigar[0].code == kS &&
      rv->cigar[0].len == rv->l_seq && rv->cigar[1].code == kN) {
    size_t voff;
    uint8_t ty;
    std::string e2;
    if (find_tag(raw, off, n, "CG", &voff, &ty, &e2) && ty == 'B' &&
        raw[voff] == 'I') {
      int32_t cnt;
      std::memcpy(&cnt, raw + voff + 1, 4);
      if (cnt < 0 || voff + 5 + 4 * (size_t)cnt > n) {
        *err = "corrupt CG tag (count exceeds record size)";
        return false;
      }
      Cig real;
      real.reserve(cnt);
      for (int i = 0; i < cnt; ++i) {
        uint32_t u;
        std::memcpy(&u, raw + voff + 5 + 4 * (size_t)i, 4);
        real.push_back({(int32_t)(u & 0xF), (int64_t)(u >> 4)});
      }
      rv->cigar = std::move(real);
      rv->cg_long = true;
    }
  }
  return true;
}

const uint8_t* packed_seq_ptr(const uint8_t* raw, const RecView& rv) {
  return raw + 32 + rv.qname.size() + 1 + 4 * (size_t)rv.n_cigar;
}

// Decode the 4-bit packed BAM seq straight into ``dst`` (ASCII), skipping
// the intermediate per-read buffer the fill used to copy from.
void decode_seq_into(const uint8_t* packed, int64_t l_seq, uint8_t* dst) {
  int64_t n2 = l_seq / 2;
#ifdef PTSCAN_X86
  if (n2 >= 32 && have_avx2()) {
    decode_seq_avx2(packed, n2, dst);
  } else
#endif
  {
    for (int64_t j = 0; j < n2; ++j)
      std::memcpy(dst + 2 * (size_t)j, kLut.dec2[packed[j]], 2);
  }
  if (l_seq & 1) dst[l_seq - 1] = kLut.dec2[packed[n2]][0];
}

// Reverse-complement decode straight from the packed stream: out[i] =
// comp(base[l_seq-1-i]).  Even lengths pair-walk dec2rc; odd lengths peel
// the final base (high nibble of the last byte) first, after which the
// remaining pairs realign to whole input bytes.
void decode_seq_rc_into(const uint8_t* packed, int64_t l_seq, uint8_t* dst) {
  int64_t i = 0;
  int64_t src = (l_seq - 1) / 2;
  if (l_seq & 1) {
    dst[0] = kLut.code_comp_ascii[packed[src] >> 4];
    i = 1;
    --src;
  }
#ifdef PTSCAN_X86
  int64_t n_pairs = (l_seq - i) / 2;
  if (n_pairs >= 32 && have_avx2()) {
    decode_rc_avx2(packed + src, n_pairs, dst + i);
    return;
  }
#endif
  for (; i < l_seq; i += 2, --src)
    std::memcpy(dst + i, kLut.dec2rc[packed[src]], 2);
}

// Flip re-pack: packed BAM seq -> revcomp packed seq (the finisher's
// flipped-record encode; no ASCII round trip).  ``dst`` needs
// (l_seq+1)/2 bytes.  Odd lengths peel the head nibble (comp of the final
// base), after which rcpack bytes straddle output bytes by one nibble.
void repack_seq_rc(const uint8_t* packed, int64_t l_seq, uint8_t* dst) {
  if (l_seq <= 0) return;
  if (l_seq & 1) {
    uint8_t cur = kLut.code_comp[packed[(l_seq - 1) / 2] >> 4];
    const uint8_t* src = packed + (l_seq - 3) / 2;
    int64_t n = l_seq / 2;
    for (int64_t k = 0; k < n; ++k, --src) {
      uint8_t rp = kLut.rcpack[*src];
      dst[k] = (uint8_t)((cur << 4) | (rp >> 4));
      cur = rp & 0xF;
    }
    dst[n] = (uint8_t)(cur << 4);
  } else {
    const uint8_t* src = packed + l_seq / 2 - 1;
#ifdef PTSCAN_X86
    if (l_seq / 2 >= 32 && have_avx2()) {
      rcpack_avx2(src, l_seq / 2, dst);
      return;
    }
#endif
    for (int64_t k = 0; k < l_seq / 2; ++k, --src)
      dst[k] = kLut.rcpack[*src];
  }
}

void decode_seq_ascii(const uint8_t* raw, const RecView& rv,
                      std::vector<uint8_t>* out) {
  size_t off = 32 + rv.qname.size() + 1 + 4 * (size_t)rv.n_cigar;
  out->resize(rv.l_seq);
  decode_seq_into(raw + off, rv.l_seq, out->data());
}

const uint8_t* qual_ptr(const uint8_t* raw, const RecView& rv) {
  return raw + 32 + rv.qname.size() + 1 + 4 * (size_t)rv.n_cigar +
         (rv.l_seq + 1) / 2;
}

// ---- split-read parsing (pipeline/split_read.py; split_read.rs:56-155) ----

struct SegView {
  int64_t so_start, so_end;
  int32_t chrom;  // contig index
  int64_t pos;
  bool fwd;
  int32_t mapq;
  Cig cigar;
  // segment came from the BAM record itself (vs its SA tag) — phase 1
  // builds block maps only for these (contig_scan._add_primary_read)
  bool from_primary = false;
};

Cig cigar_from_string(const std::string& s, std::string* err) {
  Cig out;
  if (s == "*" || s.empty()) return out;
  int64_t num = 0;
  bool have = false;
  for (char ch : s) {
    if (ch >= '0' && ch <= '9') {
      num = num * 10 + (ch - '0');
      have = true;
    } else {
      int code = -1;
      switch (ch) {
        case 'M': code = kM; break;
        case 'I': code = kI; break;
        case 'D': code = kD; break;
        case 'N': code = kN; break;
        case 'S': code = kS; break;
        case 'H': code = kH; break;
        case 'P': code = kP; break;
        case '=': code = kEq; break;
        case 'X': code = kX; break;
      }
      if (code < 0 || !have) {
        *err = "Malformed CIGAR string: '" + s + "'";
        return out;
      }
      out.push_back({(int32_t)code, num});
      num = 0;
      have = false;
    }
  }
  if (have) *err = "Malformed CIGAR string (trailing number): '" + s + "'";
  return out;
}

// ---- scanner ----

struct BucketCfg {
  int64_t max_ops, max_blocks, max_seq, max_rows;
};

struct Item {
  int32_t seg_index;
  int64_t contig_seg;        // global segment id
  int32_t contig_seg_local;  // within contig (PS tag)
  bool need_flip, is_rev_contig;
  bool host_fallback = false, skip_unmapped = false;
  bool resolved = false;
  bool has_result = false;
  int64_t ref2_pos = -1;
  Cig result;
  // device prep (computed in the parallel prep phase, consumed by fill)
  int bucket = -1;
  Cig dev_cig;
  int64_t dev_pos = 0, bm_lo = 0, bm_hi = 0, dref_lo = 0;
};

// Uninitialized raw-record buffer: reader_read fills every byte, so the
// value-init memset std::vector pays per record (~105 MB at the 18 kb
// bench shape) is pure waste.
struct RawBuf {
  std::unique_ptr<uint8_t[]> buf;
  size_t len = 0;
  RawBuf() = default;
  explicit RawBuf(size_t n) : buf(new uint8_t[n]), len(n) {}
  uint8_t* data() { return buf.get(); }
  const uint8_t* data() const { return buf.get(); }
  size_t size() const { return len; }
};

struct ReadState {
  RawBuf raw;
  RecView rv;
  std::vector<uint8_t> seq_fwd, seq_rc;  // ASCII; rc lazily filled
  std::vector<SegView> splits;
  std::vector<Item> items;
  // set by prep (producer thread), decremented by result intake (caller
  // thread); the drain pops a read only at 0, and the seq_cst atomics order
  // the intake's result writes before the finisher's reads
  std::atomic<int> unresolved{0};
  long long n_host = 0;  // fallback items computed natively during prep
};

struct PendingRef {
  ReadState* read;
  int item;
};

// Records prepped per parallel chunk (decode + split parse + item prep +
// fallback compute run across prep threads; commit stays ordered).
constexpr int64_t kChunk = 128;

// A slot is one dispatch-ready batch arena (exactly batch_size rows).
// Python wraps the buffers ZERO-COPY (jax aliases aligned numpy arrays on
// CPU) and the slot stays frozen from emit until its results are posted, so
// nothing mutates memory an async dispatch may still read.  Slots replace
// the round-2 single-buffer accumulator: no tail-shift memmove, no
// Python-side defensive batch copies.
struct Slot {
  std::vector<int32_t> ops, lens, n_ops, pos, bk, bv, nb, ref_base, win_base;
  std::vector<uint8_t> ref_win, read_seq, contig_win;
  // resident mode only: packed nibble rows (max_seq/2 per row) + per-item
  // ref chrom index (ref_win/read_seq stay empty — never allocated)
  std::vector<uint8_t> read_packed;
  std::vector<int32_t> ref_chrom;
  // Per-row content lengths from the row's PREVIOUS occupant: everything
  // beyond them is still pad from the last fill, so re-padding only the
  // [cur, prev) suffix keeps the invariant while skipping ~25% of fill
  // bytes at uniform read lengths (rows are disjoint across fill workers).
  std::vector<int32_t> prev_ops, prev_nb, prev_ref, prev_seq, prev_win;
  std::vector<int32_t> prev_pseq;  // resident mode: packed-row content len
  std::vector<PendingRef> refs;  // row -> (read, item)
  int64_t count = 0;             // rows assigned
  int accum = 0;
};

struct Accum {
  std::vector<std::unique_ptr<Slot>> all;  // owned slots (lazily grown)
  std::deque<Slot*> free_slots;
  Slot* filling = nullptr;
};

// Persistent work pool: the fork-join parallel_for spawned + joined
// threads on every prepare/fill group, which measured ~2x the actual CPU
// of the work at 18 kb chunks (profile_feed prep split).  Workers park on
// a cv between epochs; the caller participates and waits until the epoch's
// items are all done AND every worker has left the epoch (a straggler may
// grab one stale ticket after the last item completes — it sees i >= n and
// parks without executing).
struct WorkPool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv, done_cv;
  const std::function<void(int64_t)>* fn = nullptr;
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> completed{0};
  int64_t n = 0;
  uint64_t epoch = 0;
  int active = 0;
  // Epoch liveness gate (round-5 corruption fix): without it, a worker that
  // slept through epoch E entirely could wake AFTER E completed (the wake
  // predicate `epoch != seen` stays true forever), read the then-dead `fn`
  // pointer under the lock, and — once the next pool_run reset `next` to 0 —
  // claim ticket 0 and INVOKE THE DESTROYED CLOSURE of epoch E while epoch
  // E+1 ran (stack-use-after-scope; caught by ASAN at pool_worker's (*fn)(i)
  // and reproduced by ptscan_dbg_pool_stress).  That one stale call both
  // corrupts memory through the dead closure's captures and steals an item
  // of the live epoch — the wandering RA>=2 suite crashes/hangs
  // (ROUND5.md).  `in_flight` is true only while a pool_run is between
  // epoch publish and completion-observed, both transitions under `mu`, so
  // a worker can only enter an epoch whose fn is still alive (its ++active
  // then blocks pool_run's return until it leaves).
  bool in_flight = false;
  bool closing = false;
  std::exception_ptr eptr;
  Counters* ctr = nullptr;  // the scanner's (phase 1's pool has none)
};

void pool_worker(WorkPool* p) {
  ThreadRole role(p->ctr, kPrep);
  uint64_t seen = 0;
  for (;;) {
    const std::function<void(int64_t)>* fn;
    int64_t n;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv.wait(lk, [&] {
        return (p->epoch != seen && p->in_flight) || p->closing;
      });
      if (p->closing) return;
      seen = p->epoch;
      fn = p->fn;
      n = p->n;
      ++p->active;
    }
    for (;;) {
      int64_t i = p->next.fetch_add(1);
      if (i >= n) break;
      try {
        (*fn)(i);
      } catch (...) {
        std::lock_guard<std::mutex> lk(p->mu);
        if (!p->eptr) p->eptr = std::current_exception();
      }
      p->completed.fetch_add(1);
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      --p->active;
    }
    p->done_cv.notify_all();
  }
}

void pool_run(WorkPool& p, int64_t n,
              const std::function<void(int64_t)>& fn) {
  if (n <= 0) return;
  if (p.threads.empty() || n == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  {
    std::lock_guard<std::mutex> lk(p.mu);
    p.fn = &fn;
    p.n = n;
    p.next.store(0, std::memory_order_relaxed);
    p.completed.store(0, std::memory_order_relaxed);
    p.eptr = nullptr;
    ++p.epoch;
    p.in_flight = true;
  }
  p.cv.notify_all();
  for (;;) {
    int64_t i = p.next.fetch_add(1);
    if (i >= n) break;
    try {
      fn(i);
    } catch (...) {
      std::lock_guard<std::mutex> lk(p.mu);
      if (!p.eptr) p.eptr = std::current_exception();
    }
    p.completed.fetch_add(1);
  }
  std::unique_lock<std::mutex> lk(p.mu);
  wd_wait(p.done_cv, lk, "pool_run done",
          [&] { return p.completed.load() >= p.n && p.active == 0; },
          [&] {
            char b[120];
            snprintf(b, sizeof b,
                     "completed=%lld n=%lld next=%lld active=%d epoch=%llu",
                     (long long)p.completed.load(), (long long)p.n,
                     (long long)p.next.load(), p.active,
                     (unsigned long long)p.epoch);
            return std::string(b);
          });
  // close the epoch in the SAME critical section that observed completion:
  // after this unlock no worker can reach `fn` again (wake predicate
  // requires in_flight), so destroying the caller's closure is safe
  p.in_flight = false;
  if (p.eptr) {
    std::exception_ptr e = p.eptr;
    p.eptr = nullptr;
    lk.unlock();
    std::rethrow_exception(e);
  }
}

void pool_start(WorkPool& p, int n_threads) {
  for (int i = 1; i < n_threads; ++i)
    p.threads.emplace_back(pool_worker, &p);
}

void pool_stop(WorkPool& p) {
  if (p.threads.empty()) return;
  {
    std::lock_guard<std::mutex> lk(p.mu);
    p.closing = true;
  }
  p.cv.notify_all();
  for (auto& t : p.threads) t.join();
  p.threads.clear();
}

struct Scanner {
  Reader* reader = nullptr;
  Writer* remapped = nullptr;
  Writer* unassembled = nullptr;
  std::string error;

  // contig index (borrowed pointers; Python keeps them alive)
  int64_t n_contigs = 0;
  const int64_t* contig_len = nullptr;
  const int64_t* seg_off = nullptr;
  const int32_t* seg_chrom = nullptr;
  const int64_t* seg_pos = nullptr;
  const uint8_t* seg_fwd = nullptr;
  const int32_t* seg_mapq = nullptr;
  const int64_t* seg_so_start = nullptr;
  const int64_t* seg_so_end = nullptr;
  const int64_t* bm_off = nullptr;
  const int64_t* bm_keys = nullptr;
  const int64_t* bm_vals = nullptr;
  const int64_t* rc_off = nullptr;
  const uint8_t* rc_bytes = nullptr;
  std::vector<std::string> contig_names, ref_names;
  std::vector<const uint8_t*> ref_ptrs;
  std::vector<int64_t> ref_lens;
  const uint8_t* owned = nullptr;  // per-contig ownership bitmap (or null)
  bool emit_unmapped = true;
  bool is_target_region = false;
  // Rev-item routing: true (default) = left-shift on host during prep and
  // dispatch the fwd graph; false (PTPU_HOST_SHIFT=0) = device shift chain.
  bool host_shift = true;
  bool all_host = false;  // PTPU_ALL_HOST=1: no-chip leg of the offload A/B
  // Resident-reference slot mode (kernels/resident.py): rows carry the raw
  // 4-bit packed read seq (half the bytes, straight memcpy / rcpack — no
  // nibble decode) plus the item's REF CHROM index instead of the filled
  // ref_win + decoded read_seq tables; the device fetches reference windows
  // from the HBM-resident genome.  Requires host-shift routing (the
  // device-shift rev graph consumes the ASCII tables).
  bool resident = false;

  std::vector<BucketCfg> buckets;
  int64_t batch_size = 512;

  // finish FIFO: producer pushes at commit; the intake thread pops the
  // resolved prefix (fifo_mu guards the deque; drain_mu serializes whole
  // drains so the finisher receives reads in input order — see drain_fifo)
  std::mutex fifo_mu;
  std::mutex drain_mu;
  std::deque<std::unique_ptr<ReadState>> fifo;
  // Asynchronous finisher: encode + BGZF write of resolved reads runs on a
  // dedicated thread, so deflate backpressure never blocks the prep/dispatch
  // path (the round-2 profile put ~2/3 of all host feed time in the
  // synchronous drain, almost all of it deflate).  Ready reads are enqueued
  // in FIFO order and the single finisher preserves it, so output bytes are
  // identical to the synchronous form.
  std::thread finisher;
  std::mutex fin_mu;
  std::condition_variable fin_cv, fin_space;
  std::deque<std::unique_ptr<ReadState>> fin_q;
  bool fin_closing = false;
  std::string fin_error;
  // Producer thread: runs the whole scan loop (read, prep, commit, fill,
  // emit) so ptscan_next_batch only pops ready batches — the host pipeline
  // overlaps device compute instead of serializing with it.
  std::thread producer;
  std::mutex q_mu;
  std::condition_variable q_cv, q_space;
  struct EmittedBatch {
    int accum;
    Slot* slot;
    int64_t count;
  };
  std::deque<EmittedBatch> ready_q;   // emitted, not yet handed to Python
  std::deque<EmittedBatch> posted_q;  // handed out, awaiting post_results
  bool prod_done = false;
  bool shutdown = false;
  std::string prod_error;

  std::vector<Accum> accums;  // n_buckets * 2 (fwd, rev)
  bool eof = false;
  // parallel prep chunk + commit cursor (producer thread only)
  std::vector<std::unique_ptr<ReadState>> chunk;
  size_t chunk_cursor = 0;
  int prep_threads = 1;
  WorkPool pool;  // persistent prepare/fill workers (producer-driven)

  // live counters (read by ptscan_stats while the producer runs)
  std::atomic<long long> n_primary{0}, device_items{0}, host_items{0},
      fallback_items{0}, n_unassembled{0}, cur_tid{-1};

  // wall-clock phase split (ns), reported via ptscan_timing for the feed's
  // stats: serial record framing/BGZF, parallel record prep,
  // parallel item-row fill, drain handoff, result intake, EOF padding.
  // read/prepare/fill/drain/shift are producer-thread-only; post is
  // intake-thread-only (read after the producer joins).
  long long t_read_ns = 0, t_prepare_ns = 0, t_fill_ns = 0, t_drain_ns = 0,
            t_post_ns = 0, t_shift_ns = 0;
  // finisher-thread busy time (encode + BGZF write), finisher-only writes,
  // read after stop_finisher — with the producer path it bounds the feed's
  // capacity: reads/s <= n / max(producer path, t_finish)
  long long t_finish_ns = 0;
  long long t_fin_encode_ns = 0, t_fin_write_ns = 0;

  // Handed out by ptscan_counters: the run's waits and CPU time by role;
  // the exact host path's time by call site (prep: summed over the prep
  // workers; post: the caller's intake); the native threads' boundary
  // spans (now_ns, [t0, t1]).
  Counters ctr;
  mutable std::atomic<long long> host_lift_prep_ns{0};
  long long host_lift_post_ns = 0;
  struct Span {
    long long t0 = 0, t1 = 0;
  };
  Span sp_producer, sp_finisher, sp_close_remapped, sp_close_unassembled;
  long long first_slot_ns = 0;  // the producer's first emit
  std::string counters_json;
};


int64_t upper_bound_i64(const int64_t* a, int64_t n, int64_t v) {
  return std::upper_bound(a, a + n, v) - a;
}


// CPython int(str, 10) semantics for SA-tag numeric fields: surrounding
// whitespace + optional sign + digits; anything else raises ValueError with
// CPython's exact message (the Python walk is the oracle, so error parity
// is part of the contract — tests/test_contig_scan_parallel.py).
int64_t py_int10(const std::string& t) {
  size_t b = 0, e = t.size();
  while (b < e && std::isspace((unsigned char)t[b])) ++b;
  while (e > b && std::isspace((unsigned char)t[e - 1])) --e;
  size_t i = b;
  bool neg = false;
  if (i < e && (t[i] == '+' || t[i] == '-')) {
    neg = t[i] == '-';
    ++i;
  }
  bool ok = i < e;
  int64_t v = 0;
  for (; i < e && ok; ++i) {
    if (t[i] < '0' || t[i] > '9')
      ok = false;
    else
      v = v * 10 + (t[i] - '0');
  }
  if (!ok)
    throw std::runtime_error(
        "invalid literal for int() with base 10: '" + t + "'");
  return neg ? -v : v;
}

void parse_splits(const RecView& rv, std::vector<SegView>* splits,
                  const std::map<std::string, int32_t>& contig_idx) {
  int64_t left, right_start, read_len;
  cig_clip_positions(rv.cigar, &left, &right_start, &read_len);
  bool fwd = !(rv.flag & kFREVERSE);
  int64_t so_s = fwd ? left : read_len - right_start;
  int64_t so_e = fwd ? right_start : read_len - left;
  splits->push_back(
      {so_s, so_e, rv.tid, rv.pos, fwd, rv.mapq, rv.cigar, true});

  size_t voff;
  uint8_t ty;
  std::string err;
  if (find_tag(rv.raw, rv.tags_off, rv.raw_len, "SA", &voff, &ty, &err)) {
    if (ty != 'Z' && ty != 'H')
      throw std::runtime_error("Unexpected SA tag format in read " +
                               rv.qname);
    const char* s = (const char*)rv.raw + voff;
    std::string sa(s);  // NUL-terminated Z string
    // phase A — parse_sa_aux_val: parse EVERY segment's fields before any
    // cross-segment check runs (python parses the whole tag first, so a
    // malformed field in segment 2 surfaces before segment 1's size check)
    struct SaSeg {
      int64_t pos;
      bool fwd;
      Cig cigar;
      int32_t mapq;
      std::string rname, text;
    };
    std::vector<SaSeg> parsed;
    size_t i0 = 0;
    while (i0 < sa.size()) {
      size_t semi = sa.find(';', i0);
      if (semi == std::string::npos) semi = sa.size();
      std::string seg = sa.substr(i0, semi - i0);
      i0 = semi + 1;
      // Rust split_terminator(';') drops only the trailing empty; an
      // interior empty segment (doubled ';') is a hard error there
      // (sa_tag_parser.rs:54-59 + :27-31) — corrupt tags must abort.
      if (seg.empty())
        throw std::runtime_error("Unexpected segment in bam SA tag: " + seg);
      // 6 comma fields (sa_tag_parser.rs:25-46); split_terminator(',')
      // tolerates exactly one trailing empty field (trailing comma)
      std::vector<std::string> f;
      size_t p0 = 0;
      while (true) {
        size_t c = seg.find(',', p0);
        if (c == std::string::npos) {
          f.push_back(seg.substr(p0));
          break;
        }
        f.push_back(seg.substr(p0, c - p0));
        p0 = c + 1;
      }
      if (f.size() == 7 && f.back().empty()) f.pop_back();
      if (f.size() != 6)
        throw std::runtime_error("Unexpected segment in bam SA tag: " + seg);
      // field parse order mirrors parse_sa_segment: MAPQ (+u8 range),
      // then the dataclass args — pos, strand, cigar, NM
      int64_t mq_l = py_int10(f[4]);
      if (mq_l < 0 || mq_l > 255)
        throw std::runtime_error("Unexpected segment in bam SA tag: " + seg);
      int64_t sa_pos = py_int10(f[1]) - 1;
      bool sfwd = f[2] == "+";
      std::string cerr;
      Cig sc_cig = cigar_from_string(f[3], &cerr);
      if (!cerr.empty()) throw std::runtime_error(cerr);
      py_int10(f[5]);  // NM: parsed (and discarded) like the oracle
      parsed.push_back(
          {sa_pos, sfwd, std::move(sc_cig), (int32_t)mq_l, f[0], seg});
    }
    // phase B — per-segment checks in python's loop order
    for (size_t seg_i = 0; seg_i < parsed.size(); ++seg_i) {
      SaSeg& ps = parsed[seg_i];
      if (!cig_has_aligned(ps.cigar))
        throw std::runtime_error(
            "Bam record split segment id unaligned in read " + rv.qname);
      int64_t l2, r2, rl2;
      cig_clip_positions(ps.cigar, &l2, &r2, &rl2);
      if (rl2 != read_len)
        throw std::runtime_error(
            "Inconsistent split read sizes in read " + rv.qname + ": " +
            std::to_string(rl2) + " != " + std::to_string(read_len));
      auto it = contig_idx.find(ps.rname);
      if (it == contig_idx.end())
        throw std::runtime_error(
            "In read '" + rv.qname + "', the SA aux tag describes a split "
            "read mapped to " + ps.rname + ":" + std::to_string(ps.pos) +
            " (in segment " + std::to_string(seg_i) + "), which is not found "
            "in the input reference fasta");
      int64_t ss = ps.fwd ? l2 : rl2 - r2;
      int64_t se = ps.fwd ? r2 : rl2 - l2;
      splits->push_back({ss, se, it->second, ps.pos, ps.fwd,
                         ps.mapq, std::move(ps.cigar), false});
    }
    std::stable_sort(splits->begin(), splits->end(),
                     [](const SegView& a, const SegView& b) {
                       return a.so_start < b.so_start;
                     });
  }
  for (const SegView& s : *splits)
    if (s.so_start >= s.so_end)
      throw std::runtime_error(
          "Can't parse consistent split read information from SA tag format "
          "in read: " + rv.qname);
}

const std::vector<uint8_t>& seq_ascii(ReadState& rs) {
  // lazy: only the host-fallback exact path needs the ASCII form now (the
  // fill and the finisher work straight off the raw packed bytes)
  if (rs.seq_fwd.empty() && rs.rv.l_seq > 0)
    decode_seq_ascii(rs.raw.data(), rs.rv, &rs.seq_fwd);
  return rs.seq_fwd;
}

const std::vector<uint8_t>& read_seq_oriented(ReadState& rs, bool flip) {
  const std::vector<uint8_t>& fwd = seq_ascii(rs);
  if (!flip) return fwd;
  if (rs.seq_rc.empty() && !fwd.empty()) {
    rs.seq_rc.resize(fwd.size());
    for (size_t i = 0; i < fwd.size(); ++i)
      rs.seq_rc[i] = kLut.comp[fwd[fwd.size() - 1 - i]];
  }
  return rs.seq_rc;
}

// Host-exact lift of one item over the FULL block map
// (read_scan.get_liftover_alignment_for_read_and_contig_segment).
bool host_lift_item(Scanner& sc, ReadState& rs, Item& it, int64_t* out_pos,
                    Cig* out_cig) {
  const SegView& seg = rs.splits[it.seg_index];
  int64_t g = it.contig_seg;
  bool contig_is_fwd = sc.seg_fwd[g] != 0;
  int64_t bm_lo = sc.bm_off[g], bm_n = sc.bm_off[g + 1] - bm_lo;
  const uint8_t* chrom_ref = sc.ref_ptrs[sc.seg_chrom[g]];
  int64_t chrom_len = sc.ref_lens[sc.seg_chrom[g]];

  int64_t pos;
  Cig cig;
  const std::vector<uint8_t>& rseq = read_seq_oriented(rs, it.need_flip);
  if (contig_is_fwd) {
    pos = seg.pos;
    cig = seg.cigar;
  } else {
    int64_t contig_length = sc.contig_len[seg.chrom];
    int64_t seg_end = seg.pos + cig_ref_span(seg.cigar);
    pos = contig_length - seg_end;
    cig.assign(seg.cigar.rbegin(), seg.cigar.rend());
    const uint8_t* rc = sc.rc_bytes + sc.rc_off[seg.chrom];
    int64_t rc_len = sc.rc_off[seg.chrom + 1] - sc.rc_off[seg.chrom];
    Cig shifted;
    int64_t spos;
    left_shift_indels_native(pos, cig, rc, rc_len, rseq.data(),
                             (int64_t)rseq.size(), &spos, &shifted);
    pos = spos;
    cig = std::move(shifted);
  }

  // liftover over int64 block map: reuse liftover_one via int32? The full
  // maps are int64; inline an int64 variant here.
  // (ptcore's liftover_one is int32-typed for the padded batch layout.)
  {
    bool have_start = false, have_end = false;
    int64_t ref2_start = 0, ref2_end = 0;
    int64_t seg_start = pos;
    const int64_t* bk = sc.bm_keys + bm_lo;
    const int64_t* bv = sc.bm_vals + bm_lo;
    Cig em;
    for (const Op& op : cig) {
      int code = op.code;
      int64_t length = op.len;
      if (code == kI || code == kS || code == kH) {
        em.push_back({(int32_t)code, length});
      } else if (code == kP) {
      } else {
        int64_t seg_end2 = seg_start + length;
        bool match = is_align_match(code);
        int64_t lo = upper_bound_i64(bk, bm_n, seg_start) - 1;
        if (lo < 0) lo = 0;
        int64_t hi = std::lower_bound(bk, bk + bm_n, seg_end2) - bk;
        int64_t block_pos = seg_start;
        bool have_last = false;
        int64_t last_key = 0, last_val = 0;
        for (int64_t i = lo; i <= hi; ++i) {
          bool has_this = i < hi;
          int64_t end = has_this ? std::min(bk[i], seg_end2) : seg_end2;
          if (end > block_pos) {
            int64_t seg_len = end - block_pos;
            if (!have_last) {
              if (match) em.push_back({kS, seg_len});
            } else if (last_val < 0) {
              if (match) em.push_back({kI, seg_len});
            } else {
              if (match && !have_start) {
                have_start = true;
                ref2_start = last_val + (block_pos - last_key);
              }
              if (have_end) {
                int64_t dl = last_val - ref2_end;
                if (dl > 0 && have_start) em.push_back({kD, dl});
              }
              ref2_end = last_val + (end - last_key);
              have_end = true;
              if (match || have_start) {
                int c2 = code == kD ? kD : (code == kN ? kN : kM);
                em.push_back({(int32_t)c2, seg_len});
              }
            }
            block_pos = end;
          }
          if (has_this) {
            have_last = true;
            last_key = bk[i];
            last_val = bv[i];
          }
        }
      }
      if (consumes_ref(code)) seg_start += length;
    }
    if (!have_start) return false;
    int64_t lifted_pos = ref2_start + cleanup_and_compress(&em);

    // read-length invariant (read_alignment_scanner.rs:204-229)
    int64_t crl = cig_read_len_hard(em);
    if (crl != (int64_t)rs.rv.l_seq)
      throw std::runtime_error(
          "Failed to remap qname: " + rs.rv.qname + ": seq len " +
          std::to_string(rs.rv.l_seq) + " != lifted cigar read len " +
          std::to_string(crl));

    Cig simp;
    (void)chrom_len;  // simplify indexes the full chromosome absolutely
    int64_t new_pos = simplify_one(lifted_pos, em, chrom_ref, rseq.data(), &simp);
    *out_pos = new_pos;
    *out_cig = std::move(simp);
  }
  return true;
}

// ---- output record building (read_scan.py finish_*; bam.py encode) ----

// hts_reg2bin (io/bai.py:27-40)
int bam_reg2bin(int64_t beg, int64_t end) {
  --end;
  int l = 5, s = 14, t = ((1 << 15) - 1) / 7;
  while (l > 0) {
    if ((beg >> s) == (end >> s)) return t + (int)(beg >> s);
    --l;
    s += 3;
    t -= 1 << (l * 3);
  }
  return 0;
}

struct OutRecord {
  uint16_t flag;
  int32_t tid;
  int64_t pos;
  uint8_t mapq;
  Cig cigar;
  bool flipped;     // seq/qual emitted reverse-complemented
  std::string ps;   // PS tag (empty = none)
  bool has_zm = false;
  uint8_t zm = 0;
  std::string sa;   // SA tag (empty = none)
};

void append_tags_filtered(const ReadState& rs, std::vector<uint8_t>* out) {
  // clone_record semantics: drop NM/SA/PS/ZM (+ CG when the input cigar was
  // CG-decoded, matching io/bam.py decode which strips it)
  const uint8_t* p = rs.rv.raw;
  size_t off = rs.rv.tags_off, end = rs.rv.raw_len;
  std::string err;
  while (off + 3 <= end) {
    size_t nxt = tag_skip(p, off, end, &err);
    if (!err.empty()) break;
    uint8_t a = p[off], b = p[off + 1];
    bool drop = (a == 'N' && b == 'M') || (a == 'S' && b == 'A') ||
                (a == 'P' && b == 'S') || (a == 'Z' && b == 'M') ||
                (rs.rv.cg_long && a == 'C' && b == 'G');
    if (!drop) out->insert(out->end(), p + off, p + nxt);
    off = nxt;
  }
}

void encode_record(const ReadState& rs, const OutRecord& r,
                   std::vector<uint8_t>* out) {
  const RecView& rv = rs.rv;
  Cig cigar = r.cigar;
  std::vector<uint8_t> extra_tags;
  int64_t l_seq = rv.l_seq;
  if (cigar.size() > 0xFFFF) {
    // long-cigar CG spill (io/bam.py encode)
    int64_t rspan = cig_ref_span(cigar);
    extra_tags.push_back('C');
    extra_tags.push_back('G');
    extra_tags.push_back('B');
    extra_tags.push_back('I');
    int32_t cnt = cigar.size();
    size_t base = extra_tags.size();
    extra_tags.resize(base + 4 + 4 * (size_t)cnt);
    std::memcpy(extra_tags.data() + base, &cnt, 4);
    for (int32_t i = 0; i < cnt; ++i) {
      uint32_t u = ((uint32_t)cigar[i].len << 4) | (uint32_t)cigar[i].code;
      std::memcpy(extra_tags.data() + base + 4 + 4 * (size_t)i, &u, 4);
    }
    cigar = {{kS, l_seq}, {kN, rspan}};
  }
  int rbin;
  if ((r.flag & kFUNMAP) || cigar.empty())
    rbin = bam_reg2bin(std::max<int64_t>(r.pos, 0),
                       std::max<int64_t>(r.pos, 0) + 1);
  else
    rbin = bam_reg2bin(r.pos, r.pos + cig_ref_span(cigar));

  size_t qn = rv.qname.size() + 1;
  out->clear();
  out->reserve(36 + qn + 4 * cigar.size() + (l_seq + 1) / 2 + l_seq + 256);
  out->resize(36);
  uint8_t* h = out->data() + 4;  // [0:4] = block size, filled last
  std::memcpy(h + 0, &r.tid, 4);
  int32_t pos32 = (int32_t)r.pos;
  std::memcpy(h + 4, &pos32, 4);
  h[8] = (uint8_t)qn;
  h[9] = r.mapq;
  uint16_t bin16 = (uint16_t)rbin, ncig = (uint16_t)cigar.size();
  std::memcpy(h + 10, &bin16, 2);
  std::memcpy(h + 12, &ncig, 2);
  std::memcpy(h + 14, &r.flag, 2);
  int32_t ls32 = (int32_t)l_seq;
  std::memcpy(h + 16, &ls32, 4);
  std::memcpy(h + 20, &rv.mtid, 4);
  std::memcpy(h + 24, &rv.mpos, 4);
  std::memcpy(h + 28, &rv.tlen, 4);
  out->insert(out->end(), rv.qname.begin(), rv.qname.end());
  out->push_back(0);
  for (const Op& o : cigar) {
    uint32_t u = ((uint32_t)o.len << 4) | (uint32_t)o.code;
    size_t b = out->size();
    out->resize(b + 4);
    std::memcpy(out->data() + b, &u, 4);
  }
  // seq 4-bit packed, straight from the raw record bytes: pass-through is
  // a memcpy; the flipped case is a reversed rcpack LUT walk (nibble swap +
  // complement; odd lengths peel the head nibble then re-align) — no ASCII
  // round trip on the finisher's encode path
  {
    const uint8_t* packed = packed_seq_ptr(rv.raw, rv);
    size_t b = out->size();
    out->resize(b + (l_seq + 1) / 2, 0);
    uint8_t* dst = out->data() + b;
    if (!r.flipped) {
      std::memcpy(dst, packed, (size_t)((l_seq + 1) / 2));
      if (l_seq & 1) dst[l_seq / 2] &= 0xF0;  // clear any stale pad nibble
    } else {
      repack_seq_rc(packed, l_seq, dst);
    }
  }
  // qual (possibly reversed)
  {
    const uint8_t* q = qual_ptr(rv.raw, rv);
    size_t b = out->size();
    out->resize(b + l_seq);
    uint8_t* dst = out->data() + b;
    if (r.flipped)
      std::reverse_copy(q, q + l_seq, dst);
    else
      std::memcpy(dst, q, l_seq);
  }
  append_tags_filtered(rs, out);
  if (!r.ps.empty()) {
    out->push_back('P');
    out->push_back('S');
    out->push_back('Z');
    out->insert(out->end(), r.ps.begin(), r.ps.end());
    out->push_back(0);
  }
  if (r.has_zm) {
    out->push_back('Z');
    out->push_back('M');
    out->push_back('C');
    out->push_back(r.zm);
  }
  if (!r.sa.empty()) {
    out->push_back('S');
    out->push_back('A');
    out->push_back('Z');
    out->insert(out->end(), r.sa.begin(), r.sa.end());
    out->push_back(0);
  }
  out->insert(out->end(), extra_tags.begin(), extra_tags.end());
  int32_t bsz = (int32_t)(out->size() - 4);
  std::memcpy(out->data(), &bsz, 4);
}

// finish_remapped_alignment_set (read_scan.py:215-251;
// read_alignment_scanner.rs:310-366).  Appends the read's encoded output
// records to *out (pure w.r.t. the scanner — safe to run per-read in
// parallel; the caller writes buffers in FIFO order).
void finish_read(const Scanner& sc, ReadState& rs, std::vector<uint8_t>* out) {
  std::vector<OutRecord> recs;
  for (Item& it : rs.items) {
    if (!it.has_result) continue;
    const SegView& seg = rs.splits[it.seg_index];
    int64_t g = it.contig_seg;
    bool contig_is_fwd = sc.seg_fwd[g] != 0;
    OutRecord r;
    r.tid = sc.seg_chrom[g];
    r.pos = it.ref2_pos;
    r.cigar = std::move(it.result);
    r.mapq = (uint8_t)sc.seg_mapq[g];
    r.ps = sc.contig_names[seg.chrom] + "_split" +
           std::to_string(it.contig_seg_local) + (contig_is_fwd ? "+" : "-");
    r.has_zm = true;
    r.zm = rs.rv.mapq;
    r.flag = rs.rv.flag;
    r.flipped = false;
    if (it.need_flip) {
      r.flag ^= kFREVERSE;
      r.flipped = true;
    }
    r.flag |= kFSUPPL;
    recs.push_back(std::move(r));
  }
  std::vector<uint8_t> buf;
  if (recs.empty()) {
    if (sc.is_target_region) return;
    OutRecord r;
    r.flag = rs.rv.flag | kFUNMAP;
    r.flag &= ~kFSUPPL;
    r.tid = -1;
    r.pos = -1;
    r.mapq = 255;
    r.flipped = false;
    if (r.flag & kFREVERSE) {
      r.flag ^= kFREVERSE;
      r.flipped = true;
    }
    encode_record(rs, r, &buf);
    out->insert(out->end(), buf.begin(), buf.end());
    return;
  }
  size_t primary = 0;
  for (size_t i = 1; i < recs.size(); ++i)
    if (recs[primary].mapq < recs[i].mapq) primary = i;
  recs[primary].flag &= ~kFSUPPL;
  if (recs.size() > 1) {
    std::vector<std::string> parts;
    for (const OutRecord& r : recs) {
      // get_sa_tag_segment (read_scan.py:205-212); NM hardcoded 0
      bool rev = (r.flag & kFREVERSE) != 0;
      parts.push_back(sc.ref_names[r.tid] + "," +
                      std::to_string(r.pos + 1) + "," + (rev ? "-" : "+") +
                      "," + cig_to_string(r.cigar) + "," +
                      std::to_string((int)r.mapq) + ",0;");
    }
    for (size_t i = 0; i < recs.size(); ++i) {
      std::string aux;
      for (size_t j = 0; j < parts.size(); ++j)
        if (j != i) aux += parts[j];
      if (!aux.empty()) recs[i].sa = aux;
    }
  }
  for (const OutRecord& r : recs) {
    encode_record(rs, r, &buf);
    out->insert(out->end(), buf.begin(), buf.end());
  }
}

// Queue cap for the finisher handoff: bounds resident ReadStates (each holds
// the raw record + oriented sequence, ~60 KB at 18 kb reads => ~60 MB).
// Blocking here is honest backpressure when deflate is the true bottleneck.
constexpr size_t kFinQCap = 1024;

void finisher_main(Scanner* scp) {
  Scanner& sc = *scp;
  ThreadRole role(&sc.ctr, kFinisher);
  std::vector<std::unique_ptr<ReadState>> grab;
  std::vector<uint8_t> buf;
  for (;;) {
    bool failed;
    {
      std::unique_lock<std::mutex> lk(sc.fin_mu);
      sc.fin_cv.wait(lk, [&] { return !sc.fin_q.empty() || sc.fin_closing; });
      if (sc.fin_q.empty() && sc.fin_closing) return;
      while (!sc.fin_q.empty() && grab.size() < 256) {
        grab.push_back(std::move(sc.fin_q.front()));
        sc.fin_q.pop_front();
      }
      failed = !sc.fin_error.empty();
    }
    sc.fin_space.notify_all();
    if (!failed) {
      try {
        long long tf0 = now_ns();
        if (!sc.sp_finisher.t0) sc.sp_finisher.t0 = tf0;
        for (auto& r : grab) {
          buf.clear();
          finish_read(sc, *r, &buf);
          long long tw0 = now_ns();
          sc.t_fin_encode_ns += tw0 - tf0;
          if (!buf.empty()) ptio_write(sc.remapped, buf.data(), buf.size());
          tf0 = now_ns();
          sc.t_fin_write_ns += tf0 - tw0;
        }
        sc.t_finish_ns = sc.t_fin_encode_ns + sc.t_fin_write_ns;
        sc.sp_finisher.t1 = tf0;
      } catch (const std::exception& e) {
        std::lock_guard<std::mutex> lk(sc.fin_mu);
        if (sc.fin_error.empty()) sc.fin_error = e.what();
        sc.fin_space.notify_all();
        // keep draining (discarding) so enqueuers never deadlock; the error
        // surfaces on the next drain_fifo / ptscan_finish
      }
    }
    grab.clear();
  }
}

void stop_finisher(Scanner& sc) {
  if (!sc.finisher.joinable()) return;
  {
    std::lock_guard<std::mutex> lk(sc.fin_mu);
    sc.fin_closing = true;
  }
  sc.fin_cv.notify_all();
  sc.finisher.join();
}

void drain_fifo(Scanner& sc) {
  // Hand the resolved FIFO prefix to the finisher thread (encode + write
  // happen off the prep/dispatch path; order preserved).  Runs on both the
  // producer (after fills) and the intake thread (after posts): drain_mu
  // serializes the whole pop->enqueue so two concurrent drains cannot
  // interleave their prefixes out of order at the finisher queue.
  std::lock_guard<std::mutex> dlk(sc.drain_mu);
  std::vector<std::unique_ptr<ReadState>> ready;
  {
    std::lock_guard<std::mutex> flk(sc.fifo_mu);
    while (!sc.fifo.empty() &&
           sc.fifo.front()->unresolved.load(std::memory_order_acquire) == 0) {
      ready.push_back(std::move(sc.fifo.front()));
      sc.fifo.pop_front();
    }
  }
  if (ready.empty()) return;
  std::unique_lock<std::mutex> lk(sc.fin_mu);
  wd_wait(sc.fin_space, lk, "drain_fifo fin space",
          [&] {
            return sc.fin_q.size() < kFinQCap || !sc.fin_error.empty();
          },
          [&] {
            char b[120];
            snprintf(b, sizeof b, "fin_q=%zu closing=%d err='%s'",
                     sc.fin_q.size(), (int)sc.fin_closing,
                     sc.fin_error.c_str());
            return std::string(b);
          });
  if (!sc.fin_error.empty()) throw std::runtime_error(sc.fin_error);
  for (auto& r : ready) sc.fin_q.push_back(std::move(r));
  lk.unlock();
  sc.fin_cv.notify_one();
}

// DeviceEngine._prep_item semantics (models/pipeline_model.py:217-287)
// Prep decisions for one (read segment x contig segment) item — runs in a
// worker thread; mutates only rs (DeviceEngine._prep_item semantics,
// models/pipeline_model.py:217-287).
void prepare_item(const Scanner& sc, ReadState& rs, int seg_index, int64_t g,
                  int32_t local) {
  // Host-shift routing (default): the reverse-contig re-normalization
  // (reference read_alignment_scanner.rs:159-176) runs here on the host —
  // a few microseconds of byte compares — so rev items dispatch the SAME
  // fwd device graph as fwd items instead of the 3x-cost device shift
  // chain.  PTPU_HOST_SHIFT=0 restores the device-shift routing.
  bool contig_is_fwd = sc.seg_fwd[g] != 0;
  bool rec_rev = (rs.rv.flag & kFREVERSE) != 0;
  const SegView& rseg = rs.splits[seg_index];
  bool changes_strand = rec_rev == rseg.fwd;
  bool need_flip = (!contig_is_fwd) != changes_strand;  // XOR

  Item it;
  it.seg_index = seg_index;
  it.contig_seg = g;
  it.contig_seg_local = local;
  it.need_flip = need_flip;
  it.is_rev_contig = !contig_is_fwd;

  int64_t pos;
  Cig cig;
  if (contig_is_fwd) {
    pos = rseg.pos;
    cig = rseg.cigar;
  } else {
    int64_t contig_length = sc.contig_len[rseg.chrom];
    int64_t seg_end = rseg.pos + cig_ref_span(rseg.cigar);
    pos = contig_length - seg_end;
    cig.assign(rseg.cigar.rbegin(), rseg.cigar.rend());
    if (sc.host_shift) {
      // exact oracle shift against the reversed contig; the item then
      // proceeds through the fwd prep below (same device graph as fwd)
      const uint8_t* rc = sc.rc_bytes + sc.rc_off[rseg.chrom];
      int64_t rc_len = sc.rc_off[rseg.chrom + 1] - sc.rc_off[rseg.chrom];
      const std::vector<uint8_t>& rseq = read_seq_oriented(rs, need_flip);
      Cig shifted;
      int64_t spos;
      left_shift_indels_native(pos, cig, rc, rc_len, rseq.data(),
                               (int64_t)rseq.size(), &spos, &shifted);
      pos = spos;
      cig = std::move(shifted);
      it.is_rev_contig = false;  // routes through the fwd accumulator/graph
    }
  }
  int64_t span = cig_ref_span(cig);
  int64_t bm_o = sc.bm_off[g], bm_n = sc.bm_off[g + 1] - bm_o;
  const int64_t* bk = sc.bm_keys + bm_o;
  const int64_t* bv = sc.bm_vals + bm_o;
  int64_t lo = upper_bound_i64(bk, bm_n, pos) - 1;
  if (lo < 0) lo = 0;
  int64_t hi = std::lower_bound(bk, bk + bm_n, pos + span) - bk;

  bool any_valid = false;
  int64_t ref_lo = 0, ref_hi = 0;
  for (int64_t i = lo; i < hi; ++i) {
    if (bv[i] < 0) continue;
    // nxt = next key in the slice, or pos+span for the last entry
    // (_prep_item: np.concatenate([keys[1:], [pos + span]]))
    int64_t nxt = (i + 1 < hi) ? bk[i + 1] : pos + span;
    int64_t end_v = bv[i] + std::min(nxt, pos + span) - bk[i];
    if (!any_valid) {
      ref_lo = bv[i];
      ref_hi = end_v;
      any_valid = true;
    } else {
      ref_lo = std::min(ref_lo, bv[i]);
      ref_hi = std::max(ref_hi, end_v);
    }
  }
  if (!any_valid) {
    it.skip_unmapped = true;
    it.resolved = true;
    rs.items.push_back(std::move(it));
    return;
  }
  int64_t ref_span = ref_hi - ref_lo;
  int64_t n_cig = (int64_t)cig.size();
  int64_t seq_len = (int64_t)rs.rv.l_seq;

  // Liftover update-grid rows under the device formula
  // (pipeline_model._count_update_rows / liftover_parallel visits): per
  // ref-consuming op, block visits hi-lo+1 over the WINDOW keys; 1 per
  // read-only I/S/H op.  Buckets with a reduced max_rows spill on this.
  const int64_t* wk = bk + lo;
  int64_t wn = hi - lo;
  int64_t n_rows = 0;
  {
    int64_t os = pos;
    for (const Op& o : cig) {
      if (consumes_ref(o.code)) {
        int64_t oe = os + o.len;
        int64_t olo_raw = upper_bound_i64(wk, wn, os);
        int64_t ohi = std::lower_bound(wk, wk + wn, oe) - wk;
        if (ohi > wn) ohi = wn;
        int64_t olo = olo_raw - 1;
        if (olo < 0) olo = 0;
        if (olo > ohi) olo = ohi;
        n_rows += ohi - olo + (olo_raw == 0 ? 1 : 0);
        os = oe;
      } else if (o.code == kI || o.code == kS || o.code == kH) {
        n_rows += 1;
      }
    }
  }
  int bucket = -1;
  for (size_t b = 0; b < sc.buckets.size(); ++b) {
    const BucketCfg& c = sc.buckets[b];
    if (n_cig <= c.max_ops && (hi - lo) <= c.max_blocks &&
        seq_len <= c.max_seq && ref_span <= c.max_seq &&
        n_rows <= c.max_rows) {
      bucket = (int)b;
      break;
    }
  }
  // Device-shift routing only: the reversed-contig window must fit the
  // bucket, and zero-length ops form phantom clusters in the device
  // left-shift.  Neither applies under host shift (the shift already ran;
  // fwd-path kernels handle zero-length ops exactly — fuzz-verified).
  bool dev_shift_item = !contig_is_fwd && !sc.host_shift;
  if (bucket >= 0 && dev_shift_item && span > sc.buckets[bucket].max_seq)
    bucket = -1;
  // Pad ops -> exact host path (device compress does not mirror the
  // reference's adjacent-Pad quirk); rev-path zero-length ops -> host
  // (phantom clusters in the device left-shift; pipeline_model._prep_item
  // parity)
  if (bucket >= 0)
    for (const Op& o : cig)
      if (o.code == kP || (dev_shift_item && o.len == 0)) {
        bucket = -1;
        break;
      }

  // PTPU_ALL_HOST=1: route every item through the exact host path (no
  // device dispatches).  This is the measured "native feed + ptcore on all
  // cores, no chip" leg of the offload A/B (BASELINE.md) — the work runs on
  // the same prep pool the production feed uses.
  if (sc.all_host) bucket = -1;

  if (bucket < 0) {
    // exact host path, natively and in-worker (engine marks host_fallback)
    it.host_fallback = true;
    it.resolved = true;
    rs.n_host += 1;
    int64_t opos;
    Cig ocig;
    long long t0 = now_ns();
    bool lifted =
        host_lift_item(const_cast<Scanner&>(sc), rs, it, &opos, &ocig);
    sc.host_lift_prep_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
    if (lifted) {
      it.has_result = true;
      it.ref2_pos = opos;
      it.result = std::move(ocig);
    }
    rs.items.push_back(std::move(it));
    return;
  }

  it.bucket = bucket;
  it.dev_cig = std::move(cig);
  it.dev_pos = pos;
  it.bm_lo = bm_o + lo;
  it.bm_hi = bm_o + hi;
  it.dref_lo = ref_lo;
  rs.items.push_back(std::move(it));
  rs.unresolved += 1;
}

// Fill one slot row from a prepared item (worker-parallel; rows are
// disjoint, so no synchronization is needed).
void fill_item_row(const Scanner& sc, ReadState& rs, const Item& it,
                   Slot& ac, const BucketCfg& c, int64_t i) {
  const SegView& rseg = rs.splits[it.seg_index];
  const Cig& cig = it.dev_cig;
  int64_t n_cig = (int64_t)cig.size();
  if (n_cig < ac.prev_ops[i]) {
    std::fill(&ac.ops[i * c.max_ops + n_cig],
              &ac.ops[i * c.max_ops + ac.prev_ops[i]], 9 /*PAD*/);
    std::fill(&ac.lens[i * c.max_ops + n_cig],
              &ac.lens[i * c.max_ops + ac.prev_ops[i]], 0);
  }
  ac.prev_ops[i] = (int32_t)n_cig;
  for (int64_t j = 0; j < n_cig; ++j) {
    ac.ops[i * c.max_ops + j] = cig[j].code;
    ac.lens[i * c.max_ops + j] = (int32_t)cig[j].len;
  }
  ac.n_ops[i] = (int32_t)n_cig;
  ac.pos[i] = (int32_t)it.dev_pos;
  int64_t nb = it.bm_hi - it.bm_lo;
  if (nb < ac.prev_nb[i]) {
    std::fill(&ac.bk[i * c.max_blocks + nb],
              &ac.bk[i * c.max_blocks + ac.prev_nb[i]], INT32_MAX);
    std::fill(&ac.bv[i * c.max_blocks + nb],
              &ac.bv[i * c.max_blocks + ac.prev_nb[i]], -1);
  }
  ac.prev_nb[i] = (int32_t)nb;
  for (int64_t j = 0; j < nb; ++j) {
    ac.bk[i * c.max_blocks + j] = (int32_t)sc.bm_keys[it.bm_lo + j];
    ac.bv[i * c.max_blocks + j] = (int32_t)sc.bm_vals[it.bm_lo + j];
  }
  ac.nb[i] = (int32_t)nb;
  if (sc.resident) {
    // resident mode: the reference stays in device HBM — emit only the ref
    // chrom index (Python maps it + ref_base to the global superblock
    // offset) and the RAW packed nibble row (memcpy / rcpack, no decode).
    ac.ref_chrom[i] = sc.seg_chrom[it.contig_seg];
    int64_t l_seq = rs.rv.l_seq;
    int64_t n_packed = (l_seq + 1) / 2;
    int64_t row_w = (c.max_seq + 1) / 2;
    uint8_t* dst = &ac.read_packed[i * row_w];
    const uint8_t* packed = packed_seq_ptr(rs.raw.data(), rs.rv);
    if (it.need_flip) {
      repack_seq_rc(packed, l_seq, dst);
    } else {
      std::memcpy(dst, packed, n_packed);
      // odd length: the BAM pad nibble should be 0 per spec, but mask it so
      // a nonconforming producer can't leak bytes past the read into the
      // row (the device widens it to '='; output-neutral either way)
      if (l_seq & 1) dst[n_packed - 1] &= 0xF0;
    }
    if (n_packed < ac.prev_pseq[i])
      std::memset(dst + n_packed, 0, ac.prev_pseq[i] - n_packed);
    ac.prev_pseq[i] = (int32_t)n_packed;
  } else {
    {
      int64_t g = it.contig_seg;
      const uint8_t* chrom_ref = sc.ref_ptrs[sc.seg_chrom[g]];
      int64_t chrom_len = sc.ref_lens[sc.seg_chrom[g]];
      int64_t w_end = std::min(
          it.dref_lo + c.max_seq, chrom_len);  // window covers <= max_seq
      int64_t w_len = std::max<int64_t>(w_end - it.dref_lo, 0);
      std::memcpy(&ac.ref_win[i * c.max_seq], chrom_ref + it.dref_lo, w_len);
      if (w_len < ac.prev_ref[i])
        std::memset(&ac.ref_win[i * c.max_seq + w_len], 0,
                    ac.prev_ref[i] - w_len);
      ac.prev_ref[i] = (int32_t)w_len;
    }
    // decode the 4-bit packed BAM seq straight into the slot row (one pass;
    // the old ASCII staging buffer cost a full extra write+read per record)
    int64_t l_seq = rs.rv.l_seq;
    uint8_t* dst = &ac.read_seq[i * c.max_seq];
    const uint8_t* packed = packed_seq_ptr(rs.raw.data(), rs.rv);
    if (it.need_flip)
      decode_seq_rc_into(packed, l_seq, dst);
    else
      decode_seq_into(packed, l_seq, dst);
    if (l_seq < ac.prev_seq[i])
      std::memset(dst + l_seq, 0, ac.prev_seq[i] - l_seq);
    ac.prev_seq[i] = (int32_t)l_seq;
  }
  ac.ref_base[i] = (int32_t)it.dref_lo;
  if (it.is_rev_contig) {
    int64_t span = cig_ref_span(cig);
    const uint8_t* rc = sc.rc_bytes + sc.rc_off[rseg.chrom];
    int64_t rc_len = sc.rc_off[rseg.chrom + 1] - sc.rc_off[rseg.chrom];
    int64_t w_len =
        std::min(span, std::max<int64_t>(rc_len - it.dev_pos, 0));
    std::memcpy(&ac.contig_win[i * c.max_seq], rc + it.dev_pos, w_len);
    if (w_len < ac.prev_win[i])
      std::memset(&ac.contig_win[i * c.max_seq + w_len], 0,
                  ac.prev_win[i] - w_len);
    ac.prev_win[i] = (int32_t)w_len;
    ac.win_base[i] = (int32_t)it.dev_pos;
  }
}

// Parse + prep one raw record into a ReadState (worker thread; no Scanner
// mutation).
std::unique_ptr<ReadState> prepare_read(
    const Scanner& sc, RawBuf&& raw,
    const std::map<std::string, int32_t>& contig_idx) {
  auto rs = std::make_unique<ReadState>();
  rs->raw = std::move(raw);
  std::string err;
  if (!parse_record(rs->raw.data(), rs->raw.size(), &rs->rv, &err))
    throw std::runtime_error(err);
  // seq ASCII decode is lazy now (host-fallback items only): the fill and
  // the finisher consume the raw packed bytes directly
  parse_splits(rs->rv, &rs->splits, contig_idx);

  // per read split segment x intersecting contig segment
  // (read_scan.get_contig_split_segments_from_read_mapping)
  for (size_t si = 0; si < rs->splits.size(); ++si) {
    const SegView& rseg = rs->splits[si];
    int64_t r_lo = rseg.pos;
    int64_t r_hi = rseg.pos + cig_ref_span(rseg.cigar);
    int64_t s0 = sc.seg_off[rseg.chrom], s1 = sc.seg_off[rseg.chrom + 1];
    for (int64_t g = s0; g < s1; ++g) {
      int64_t c_lo = sc.seg_so_start[g], c_hi = sc.seg_so_end[g];
      // IntRange.intersect_range: half-open overlap
      if (std::max(r_lo, c_lo) < std::min(r_hi, c_hi))
        prepare_item(sc, *rs, (int)si, g, (int32_t)(g - s0));
    }
  }
  // (the old eager seq_rc materialization is gone: the fill decodes the
  // flipped row straight from the raw packed bytes.  The remaining ASCII
  // consumers are host shift / fallback compute inside prepare (this thread
  // owns the read) AND host_lift_item re-runs from ptscan_post_results for
  // device-overflow rows — the latter is safe only because post_results is
  // invoked from the single Python drive thread; if results intake ever
  // moves onto a pool, the lazy seq_fwd/seq_rc init needs a per-read lock)
  return rs;
}

struct FillJob {
  ReadState* read;
  int item;
  Slot* slot;
  int64_t row;
};

// Pop a free slot for accumulator ai, or allocate one.  Allocation is
// unbounded on purpose: within one commit group a single read can complete
// several slots that cannot be emitted until their fills run, so a hard cap
// could deadlock.  Steady-state slot count is bounded by the emit-side
// ready_q cap (producer stalls at ~2 ready + 2 in-flight + 1 filling).
Slot* get_free_slot(Scanner& sc, int ai) {
  Accum& ac = sc.accums[ai];
  {
    std::lock_guard<std::mutex> lk(sc.q_mu);
    if (!ac.free_slots.empty()) {
      Slot* s = ac.free_slots.front();
      ac.free_slots.pop_front();
      return s;
    }
  }
  const BucketCfg& c = sc.buckets[ai / 2];
  bool rev = ai % 2;
  int64_t rows = sc.batch_size;
  auto s = std::make_unique<Slot>();
  s->accum = ai;
  s->ops.assign(rows * c.max_ops, 9 /*PAD*/);
  s->lens.assign(rows * c.max_ops, 0);
  s->n_ops.assign(rows, 0);
  s->pos.assign(rows, 0);
  s->bk.assign(rows * c.max_blocks, INT32_MAX);
  s->bv.assign(rows * c.max_blocks, -1);
  s->nb.assign(rows, 0);
  if (sc.resident) {
    s->read_packed.assign(rows * ((c.max_seq + 1) / 2), 0);
    s->ref_chrom.assign(rows, 0);
    s->prev_pseq.assign(rows, 0);
  } else {
    s->ref_win.assign(rows * c.max_seq, 0);
    s->read_seq.assign(rows * c.max_seq, 0);
  }
  s->ref_base.assign(rows, 0);
  if (rev) {
    s->contig_win.assign(rows * c.max_seq, 0);
    s->win_base.assign(rows, 0);
  }
  s->prev_ops.assign(rows, 0);
  s->prev_nb.assign(rows, 0);
  s->prev_ref.assign(rows, 0);
  s->prev_seq.assign(rows, 0);
  s->prev_win.assign(rows, 0);
  Slot* p = s.get();
  std::lock_guard<std::mutex> lk(sc.q_mu);
  ac.all.push_back(std::move(s));
  return p;
}

// Pad rows [count, batch_size) of a partial slot (EOF flush; reused slots
// carry stale rows).  Pad rows lift to unmapped and are ignored by intake.
void pad_slot_tail(Scanner& sc, Slot& s) {
  const BucketCfg& c = sc.buckets[s.accum / 2];
  bool rev = s.accum % 2;
  for (int64_t i = s.count; i < sc.batch_size; ++i) {
    std::fill(&s.ops[i * c.max_ops], &s.ops[i * c.max_ops + s.prev_ops[i]],
              9 /*PAD*/);
    std::fill(&s.lens[i * c.max_ops], &s.lens[i * c.max_ops + s.prev_ops[i]],
              0);
    s.prev_ops[i] = 0;
    s.n_ops[i] = 0;
    s.pos[i] = 0;
    std::fill(&s.bk[i * c.max_blocks], &s.bk[i * c.max_blocks + s.prev_nb[i]],
              INT32_MAX);
    std::fill(&s.bv[i * c.max_blocks], &s.bv[i * c.max_blocks + s.prev_nb[i]],
              -1);
    s.prev_nb[i] = 0;
    s.nb[i] = 0;
    s.ref_base[i] = 0;
    if (sc.resident) {
      s.ref_chrom[i] = 0;
      std::memset(&s.read_packed[i * ((c.max_seq + 1) / 2)], 0,
                  s.prev_pseq[i]);
      s.prev_pseq[i] = 0;
    } else {
      std::memset(&s.ref_win[i * c.max_seq], 0, s.prev_ref[i]);
      s.prev_ref[i] = 0;
      std::memset(&s.read_seq[i * c.max_seq], 0, s.prev_seq[i]);
      s.prev_seq[i] = 0;
    }
    if (rev) {
      std::memset(&s.contig_win[i * c.max_seq], 0, s.prev_win[i]);
      s.prev_win[i] = 0;
      s.win_base[i] = 0;
    }
  }
}

// Commit one prepped read in input order: assign slot rows, queue fill
// jobs, update counters, append to the finish FIFO.  Slots that reach
// batch_size are appended to *completed (emitted after their fills run).
void commit_read(Scanner& sc, std::unique_ptr<ReadState> rs,
                 std::vector<FillJob>* jobs, std::vector<Slot*>* completed) {
  ReadState* rp = rs.get();
  sc.host_items += rp->n_host;
  for (int k = 0; k < (int)rp->items.size(); ++k) {
    Item& it = rp->items[k];
    if (it.resolved || it.bucket < 0) continue;
    int ai = it.bucket * 2 + (it.is_rev_contig ? 1 : 0);
    Accum& ac = sc.accums[ai];
    if (!ac.filling) ac.filling = get_free_slot(sc, ai);
    Slot* s = ac.filling;
    int64_t row = s->count++;
    s->refs.push_back({rp, k});
    jobs->push_back({rp, k, s, row});
    sc.device_items += 1;
    if (s->count == sc.batch_size) {
      completed->push_back(s);
      ac.filling = nullptr;
    }
  }
  std::lock_guard<std::mutex> flk(sc.fifo_mu);
  sc.fifo.push_back(std::move(rs));
}


}  // namespace


// ---------------------------------------------------------------------------
// Phase 1: contig alignment scan per-record walk
// (pipeline/contig_scan.process_record / _add_primary_read; reference
// contig_alignment_scanner/mod.rs:91-183).  The Python walk stays as the
// oracle; this native batch engine removes the ~215 us/record of GIL-bound
// small-array numpy that capped phase-1 thread scaling (PERF.md round 3).
// ---------------------------------------------------------------------------

constexpr int kFSECONDARY = 0x100;

// build_block_map(ref_pos, cigar, ignore_hard_clip=False)
// (ops/blockmap.py:79-127; reference read_to_ref_map.rs:101-137): per maximal
// M/=/X run a (read_start -> ref_start) entry plus (read_end -> -1) gap
// entry; duplicate keys keep the LAST entry (BTreeMap insert overwrite).
void build_block_map_c(int64_t ref_pos, const Cig& c,
                       std::vector<int64_t>* keys,
                       std::vector<int64_t>* vals) {
  int64_t rp = ref_pos, dp = 0;
  size_t i = 0, n = c.size();
  std::vector<int64_t> K, V;
  while (i < n) {
    if (is_align_match(c[i].code)) {
      int64_t rs0 = dp, ref0 = rp;
      while (i < n && is_align_match(c[i].code)) {
        rp += c[i].len;
        dp += c[i].len;
        ++i;
      }
      if (dp > rs0) {
        K.push_back(rs0);
        V.push_back(ref0);
        K.push_back(dp);
        V.push_back(-1);
      }
    } else {
      if (consumes_ref(c[i].code)) rp += c[i].len;
      if (consumes_read_hard(c[i].code)) dp += c[i].len;
      ++i;
    }
  }
  keys->clear();
  vals->clear();
  for (size_t j = 0; j < K.size(); ++j) {
    if (j + 1 < K.size() && K[j] == K[j + 1]) continue;  // keep last
    keys->push_back(K[j]);
    vals->push_back(V[j]);
  }
}

struct P1Rec {
  int64_t kind = 0;  // 0 skip, 1 primary, 2 supplementary
  int32_t tid = -1;
  int32_t contig = -1;  // -1 = qname not in the assembly contig list
  std::string qname;
  std::vector<SegView> segs;  // primary: ordered splits; supp: [record seg]
  // per-seg block maps (empty for non-primary segments)
  std::vector<std::vector<int64_t>> bm_keys, bm_vals;
  std::vector<uint8_t> rev;  // reverse-strand contig sequence (primary only)
  bool has_rev = false;
  int64_t supp_clip0 = 0, supp_clip1 = 0;  // supp match-key clip fields
  // per-record error ("KE:<qname>" = unknown contig KeyError; anything else
  // = ValueError text).  The caller surfaces the LOWEST-index error so
  // failure order matches the sequential Python walk exactly.
  std::string err;
};

struct P1Handle {
  std::map<std::string, int32_t> ref_idx;  // SA rname -> ref chrom index
  std::map<std::string, int32_t> ctg_idx;  // qname -> assembly contig index
  WorkPool pool;
  int pool_threads = 0;
  std::string error;
  std::vector<P1Rec> recs;
  // flattened outputs (valid until the next process call)
  std::vector<int64_t> o_rec;  // 9 per record (see ptscan_p1_results)
  std::vector<int64_t> o_seg;  // 11 per segment
  std::vector<int64_t> o_cig;  // (code, len) pairs
  std::vector<int64_t> o_bmk, o_bmv;
  std::vector<uint8_t> o_rev;
  std::vector<uint8_t> o_qname;
};

void p1_process_one(P1Handle& h, const uint8_t* raw, size_t len, P1Rec* out) {
  RecView rv;
  std::string err;
  if (!parse_record(raw, len, &rv, &err)) throw std::runtime_error(err);
  out->tid = rv.tid;
  if ((rv.flag & kFUNMAP) || (rv.flag & kFSECONDARY)) {
    out->kind = 0;
    return;
  }
  out->qname = rv.qname;
  auto it = h.ctg_idx.find(rv.qname);
  if (it == h.ctg_idx.end())
    throw std::runtime_error("KE:" + rv.qname);
  out->contig = it->second;
  if (rv.flag & kFSUPPL) {
    // supplementary: match key + exact cigar + block map (mod.rs:135-183)
    out->kind = 2;
    int64_t left, right_start, read_len;
    cig_clip_positions(rv.cigar, &left, &right_start, &read_len);
    out->supp_clip0 = left;
    out->supp_clip1 = read_len - right_start;
    SegView seg;
    seg.so_start = 0;
    seg.so_end = 0;
    seg.chrom = rv.tid;
    seg.pos = rv.pos;
    seg.fwd = !(rv.flag & kFREVERSE);
    seg.mapq = rv.mapq;
    seg.cigar = rv.cigar;
    out->segs.push_back(std::move(seg));
    out->bm_keys.emplace_back();
    out->bm_vals.emplace_back();
    build_block_map_c(rv.pos, rv.cigar, &out->bm_keys[0], &out->bm_vals[0]);
    return;
  }
  // primary (_add_primary_read, mod.rs:91-133)
  out->kind = 1;
  parse_splits(rv, &out->segs, h.ref_idx);
  bool need_rev = false;
  for (size_t si = 0; si < out->segs.size(); ++si) {
    out->bm_keys.emplace_back();
    out->bm_vals.emplace_back();
    const SegView& seg = out->segs[si];
    if (seg.from_primary)
      build_block_map_c(seg.pos, seg.cigar, &out->bm_keys[si],
                        &out->bm_vals[si]);
    if (!seg.fwd) need_rev = true;
  }
  if (need_rev) {
    // stored sequence must be the reverse-strand contig sequence: a
    // reverse-mapped record already stores it; a forward one needs
    // rev-comp (mod.rs:113-125)
    std::vector<uint8_t> seq;
    decode_seq_ascii(raw, rv, &seq);
    if (rv.flag & kFREVERSE) {
      out->rev = std::move(seq);
    } else {
      out->rev.resize(seq.size());
      for (size_t i = 0; i < seq.size(); ++i)
        out->rev[i] = kLut.comp[seq[seq.size() - 1 - i]];
    }
    out->has_rev = true;
  }
}

extern "C" {

typedef struct {
  long long bucket, is_rev, count;
  int32_t* ops;
  int32_t* lens;
  int32_t* n_ops;
  int32_t* pos;
  int32_t* bk;
  int32_t* bv;
  int32_t* nb;
  uint8_t* ref_win;
  int32_t* ref_base;
  uint8_t* read_seq;
  uint8_t* contig_win;
  int32_t* win_base;
  // resident slot mode only (null otherwise): packed nibble rows
  // (count x max_seq/2) + per-item ref chrom index
  uint8_t* read_packed;
  int32_t* ref_chrom;
} PtscanBatchDesc;

struct ScannerHandle {
  Scanner sc;
  std::map<std::string, int32_t> contig_idx;
};

void ptscan_destroy(void* hv);  // fwd decl: create's failure paths use it

void* ptscan_create(
    const char* bam_path, const char* remapped_path,
    const char* unassembled_path, const uint8_t* header_bytes,
    long long header_len, int compression_level, int writer_threads,
    long long n_contigs, const int64_t* contig_len,
    const char* contig_names_concat, const int64_t* contig_name_off,
    long long n_ref, const char* ref_names_concat,
    const int64_t* ref_name_off, const uint8_t* const* ref_ptrs,
    const int64_t* ref_lens_arr, const int64_t* seg_off,
    const int32_t* seg_chrom, const int64_t* seg_pos, const uint8_t* seg_fwd,
    const int32_t* seg_mapq, const int64_t* seg_so_start,
    const int64_t* seg_so_end, const int64_t* bm_off, const int64_t* bm_keys,
    const int64_t* bm_vals, const int64_t* rc_off, const uint8_t* rc_bytes,
    long long n_buckets, const int64_t* bucket_dims /*4 per bucket*/,
    long long batch_size, int is_target_region, const uint8_t* owned,
    int emit_unmapped, int prep_threads, void* ext_reader,
    int resident_mode, bgzf::Card* const* cards) {
  auto* h = new ScannerHandle();
  Scanner& sc = h->sc;
  // release any acquired reader/writers on every failure path (writer
  // pools spawn threads at open; a bare delete would leak fds, the mmap,
  // and pool threads parked on cv_work)
  auto fail = [&]() -> void* {
    // on failure the caller keeps ownership of ext_reader (its producer
    // thread may still be blocked in ptio_reader_push; closing here would
    // free state under it — the caller aborts + joins, then closes)
    if (ext_reader) sc.reader = nullptr;
    ptscan_destroy(h);
    return nullptr;
  };
  try {
    // ext_reader: a push-mode reader (direct CRAM streaming) already open;
    // the scanner takes ownership either way and closes it on destroy.
    sc.reader = ext_reader
                    ? static_cast<Reader*>(ext_reader)
                    : static_cast<Reader*>(ptio_reader_open(bam_path));
    if (!sc.reader) return fail();
    // skip the BAM header: magic, l_text, text, n_ref, per-ref entries —
    // every length is read-checked (a truncated header must fail cleanly,
    // not size a vector from uninitialized stack memory)
    {
      uint8_t b4[4];
      int32_t l_text = 0, nref = 0;
      if (reader_read(sc.reader, b4, 4) < 4 ||
          std::memcmp(b4, "BAM\x01", 4) != 0 ||
          reader_read(sc.reader, (uint8_t*)&l_text, 4) < 4 || l_text < 0)
        return fail();
      std::vector<uint8_t> skip(l_text);
      if (reader_read(sc.reader, skip.data(), l_text) < (size_t)l_text ||
          reader_read(sc.reader, (uint8_t*)&nref, 4) < 4 || nref < 0)
        return fail();
      for (int32_t i = 0; i < nref; ++i) {
        int32_t l_name = 0;
        if (reader_read(sc.reader, (uint8_t*)&l_name, 4) < 4 || l_name < 0)
          return fail();
        skip.resize((size_t)l_name + 4);
        if (reader_read(sc.reader, skip.data(), (size_t)l_name + 4) <
            (size_t)l_name + 4)
          return fail();
      }
    }
    // cards: the remapped and the unassembled writer's codecs on the card
    // (null: the host deflates)
    sc.remapped = writer_open(remapped_path, compression_level, writer_threads,
                              &sc.ctr, cards ? cards[0] : nullptr);
    sc.unassembled = writer_open(unassembled_path, 6, writer_threads, &sc.ctr,
                                 cards ? cards[1] : nullptr);
    if (!sc.remapped || !sc.unassembled) return fail();
  } catch (const std::exception&) {
    // exceptions must not cross the C ABI into ctypes (std::terminate)
    return fail();
  }
  ptio_write(sc.remapped, header_bytes, header_len);
  ptio_write(sc.unassembled, header_bytes, header_len);

  sc.n_contigs = n_contigs;
  sc.contig_len = contig_len;
  sc.seg_off = seg_off;
  sc.seg_chrom = seg_chrom;
  sc.seg_pos = seg_pos;
  sc.seg_fwd = seg_fwd;
  sc.seg_mapq = seg_mapq;
  sc.seg_so_start = seg_so_start;
  sc.seg_so_end = seg_so_end;
  sc.bm_off = bm_off;
  sc.bm_keys = bm_keys;
  sc.bm_vals = bm_vals;
  sc.rc_off = rc_off;
  sc.rc_bytes = rc_bytes;
  for (long long i = 0; i < n_contigs; ++i) {
    std::string name(contig_names_concat + contig_name_off[i],
                     contig_names_concat + contig_name_off[i + 1]);
    sc.contig_names.push_back(name);
    h->contig_idx[name] = (int32_t)i;
  }
  for (long long i = 0; i < n_ref; ++i) {
    sc.ref_names.emplace_back(ref_names_concat + ref_name_off[i],
                              ref_names_concat + ref_name_off[i + 1]);
    sc.ref_ptrs.push_back(ref_ptrs[i]);
    sc.ref_lens.push_back(ref_lens_arr[i]);
  }
  for (long long b = 0; b < n_buckets; ++b)
    sc.buckets.push_back({bucket_dims[4 * b], bucket_dims[4 * b + 1],
                          bucket_dims[4 * b + 2], bucket_dims[4 * b + 3]});
  sc.batch_size = batch_size;
  // direct-construct at size (Accum holds unique_ptrs; resize would need a
  // noexcept move, which deque lacks)
  sc.accums = std::vector<Accum>(n_buckets * 2);
  sc.is_target_region = is_target_region != 0;
  sc.owned = owned;
  sc.emit_unmapped = emit_unmapped != 0;
  sc.prep_threads = prep_threads < 1 ? 1 : prep_threads;
  {
    // read per-create (not a function-local static) so tests can toggle the
    // routing between runs within one process
    const char* e = getenv("PTPU_HOST_SHIFT");
    sc.host_shift = !(e && e[0] == '0');
    const char* ah = getenv("PTPU_ALL_HOST");
    sc.all_host = ah && ah[0] == '1';
    // resident slot mode needs every device item on the fwd graph (the
    // device-shift rev graph consumes the ASCII tables), so host-shift
    // routing is a hard requirement
    sc.resident = resident_mode != 0 && sc.host_shift;
  }
  // Parallel BGZF readahead: the serial inflate in the framing loop was the
  // measured host-feed ceiling (~42 us/item at 18 kb; PERF.md phase split).
  // Default width = prep_threads - 1 (floor 2): with the round-5 resident
  // fill the producer's other legs got light enough that a full-width
  // readahead pool CONTENDS with prepare/fill/finisher on small hosts —
  // RA=3 vs 4 on the 4-core box cut the read leg 0.10 -> 0.03-0.05 s and
  // lifted feed capacity ~25% (PERF.md round 5).  PTPU_RA_THREADS overrides.
  // (An earlier attempt to ship this default was reverted after suite
  // hangs/crashes; the root cause was the WorkPool stale-epoch closure
  // invocation — see the `in_flight` comment above — which the changed RA
  // scheduling merely exposed.  Fixed and regression-covered by
  // ptscan_dbg_pool_stress; re-validated with 3/3 full suites at RA=3 and
  // the ASAN feed-test loop.)
  {
    const char* rt = getenv("PTPU_RA_THREADS");
    int n = rt ? atoi(rt)
               : (sc.prep_threads > 2 ? sc.prep_threads - 1 : 2);
    sc.reader->ctr = &sc.ctr;
    ptio_reader_set_threads(sc.reader, n);
  }
  sc.pool.ctr = &sc.ctr;
  pool_start(sc.pool, sc.prep_threads);
  sc.finisher = std::thread(finisher_main, &sc);
  return h;
}

const char* ptscan_error(void* hv) {
  return static_cast<ScannerHandle*>(hv)->sc.error.c_str();
}

// Block until the ready queue has room (<= 2 emitted-unclaimed batches:
// bounds how far the producer runs ahead, and with it slot/FIFO memory),
// then publish the slot.  Throws on shutdown so the producer unwinds.
void emit_slot(Scanner& sc, Slot* s) {
  std::unique_lock<std::mutex> lk(sc.q_mu);
  wd_wait(sc.q_space, lk, "emit_slot space",
          [&] { return sc.ready_q.size() < 2 || sc.shutdown; },
          [&] {
            char b[96];
            snprintf(b, sizeof b, "ready=%zu posted=%zu shutdown=%d",
                     sc.ready_q.size(), sc.posted_q.size(),
                     (int)sc.shutdown);
            return std::string(b);
          });
  if (sc.shutdown) throw std::runtime_error("scanner shut down");
  sc.ready_q.push_back({s->accum, s, s->count});
  if (!sc.first_slot_ns) sc.first_slot_ns = now_ns();
  lk.unlock();
  sc.q_cv.notify_one();
}

// The scan loop (runs on the producer thread): read + prep chunks, commit
// in input order, fill slot rows in parallel, emit completed slots.
void producer_main(Scanner* scp, ScannerHandle* h) {
  Scanner& sc = *scp;
  ThreadRole role(&sc.ctr, kProducer);
  sc.sp_producer.t0 = now_ns();
  try {
    std::deque<Slot*> completed;
    for (;;) {
      while (!completed.empty()) {
        emit_slot(sc, completed.front());
        completed.pop_front();
      }

      // commit prepped records (input order) until a slot completes
      if (sc.chunk_cursor < sc.chunk.size()) {
        std::vector<FillJob> jobs;
        std::vector<Slot*> comp;
        while (sc.chunk_cursor < sc.chunk.size() && comp.empty())
          commit_read(sc, std::move(sc.chunk[sc.chunk_cursor++]), &jobs,
                      &comp);
        // fill assigned rows in parallel (disjoint rows)
        long long t0 = now_ns();
        pool_run(sc.pool, (int64_t)jobs.size(), [&](int64_t j) {
          const FillJob& fj = jobs[j];
          fill_item_row(sc, *fj.read, fj.read->items[fj.item], *fj.slot,
                        sc.buckets[fj.slot->accum / 2], fj.row);
        });
        long long t1 = now_ns();
        drain_fifo(sc);
        long long t2 = now_ns();
        sc.t_fill_ns += t1 - t0;
        sc.t_drain_ns += t2 - t1;
        for (Slot* s : comp) completed.push_back(s);
        continue;
      }

      if (sc.eof) break;

      // load + parallel-prep the next chunk of mapped primary records
      long long t_load0 = now_ns();
      std::vector<RawBuf> raws;
      raws.reserve(kChunk);
      while ((int64_t)raws.size() < kChunk) {
        uint8_t szb[4];
        if (reader_read(sc.reader, szb, 4) < 4) {
          sc.eof = true;
          break;
        }
        int32_t bsz;
        std::memcpy(&bsz, szb, 4);
        if (bsz < 32) throw std::runtime_error("invalid BAM record size");
        RawBuf raw((size_t)bsz);
        if (reader_read(sc.reader, raw.data(), bsz) < (size_t)bsz)
          throw std::runtime_error("truncated BAM record");
        uint16_t flag;
        int32_t tid;
        std::memcpy(&tid, raw.data() + 0, 4);
        std::memcpy(&flag, raw.data() + 14, 2);
        if (flag & kFUNMAP) {
          // reference semantics: unplaced section passes through
          // (FetchDefinition::Unmapped, read_alignment_scanner.rs:537-559);
          // a placed unmapped record would fail the scan's assert (:396).
          if (tid >= 0) {
            uint8_t l_read_name = raw.data()[8];
            std::string qn((const char*)raw.data() + 32,
                           l_read_name ? l_read_name - 1 : 0);
            throw std::runtime_error(
                "unexpected placed unmapped record in read: " + qn);
          }
          if (sc.emit_unmapped) {
            uint8_t frame[4];
            std::memcpy(frame, &bsz, 4);
            ptio_write(sc.unassembled, frame, 4);
            ptio_write(sc.unassembled, raw.data(), bsz);
            sc.n_unassembled += 1;
          }
          continue;
        }
        if (flag & kFSUPPL) continue;
        sc.cur_tid = tid;
        if (sc.owned && !sc.owned[tid]) continue;
        sc.n_primary += 1;
        raws.push_back(std::move(raw));
      }
      sc.chunk.clear();
      sc.chunk.resize(raws.size());
      sc.chunk_cursor = 0;
      long long t_load1 = now_ns();
      pool_run(sc.pool, (int64_t)raws.size(), [&](int64_t i) {
        sc.chunk[i] = prepare_read(sc, std::move(raws[i]), h->contig_idx);
      });
      long long t_load2 = now_ns();
      sc.t_read_ns += t_load1 - t_load0;
      sc.t_prepare_ns += t_load2 - t_load1;
    }
    // EOF: pad + emit partial slots (accumulator order, deterministic)
    for (size_t ai = 0; ai < sc.accums.size(); ++ai) {
      Slot* s = sc.accums[ai].filling;
      if (!s || s->count == 0) continue;
      long long tp0 = now_ns();
      pad_slot_tail(sc, *s);
      sc.t_shift_ns += now_ns() - tp0;
      sc.accums[ai].filling = nullptr;
      emit_slot(sc, s);
    }
    // best-effort final drain (reads resolved entirely during prep); the
    // caller's post_results drains the rest, ptscan_finish is the backstop
    drain_fifo(sc);
  } catch (const std::exception& e) {
    std::lock_guard<std::mutex> lk(sc.q_mu);
    if (sc.prod_error.empty()) sc.prod_error = e.what();
  }
  {
    std::lock_guard<std::mutex> lk(sc.q_mu);
    sc.sp_producer.t1 = now_ns();
    sc.prod_done = true;
  }
  sc.q_cv.notify_all();
}

void stop_producer(Scanner& sc) {
  if (!sc.producer.joinable()) return;
  {
    std::lock_guard<std::mutex> lk(sc.q_mu);
    sc.shutdown = true;
  }
  sc.q_space.notify_all();
  sc.producer.join();
}

// 1 = batch ready, 0 = done, -1 = error,
// 2 = EOF with results outstanding (post them, then call again)
int ptscan_next_batch(void* hv, PtscanBatchDesc* out) {
  auto* h = static_cast<ScannerHandle*>(hv);
  Scanner& sc = h->sc;
  ThreadRole role(&sc.ctr, kMain, false);
  // lazy start: the first batch request launches the scan loop
  if (!sc.producer.joinable() && !sc.prod_done)
    sc.producer = std::thread(producer_main, &sc, h);
  Scanner::EmittedBatch eb;
  {
    std::unique_lock<std::mutex> lk(sc.q_mu);
    wd_wait(sc.q_cv, lk, "next_batch ready",
            [&] { return !sc.ready_q.empty() || sc.prod_done; },
            [&] {
              // q_mu-protected fields only (the dump itself must not race)
              char b[120];
              snprintf(b, sizeof b,
                       "ready=%zu posted=%zu prod_done=%d shutdown=%d",
                       sc.ready_q.size(), sc.posted_q.size(),
                       (int)sc.prod_done, (int)sc.shutdown);
              return std::string(b);
            });
    if (!sc.prod_error.empty()) {
      sc.error = sc.prod_error;
      return -1;
    }
    if (sc.ready_q.empty()) {
      if (!sc.posted_q.empty()) return 2;
      return 0;
    }
    eb = sc.ready_q.front();
    sc.ready_q.pop_front();
    sc.posted_q.push_back(eb);
  }
  sc.q_space.notify_all();
  Slot* s = eb.slot;
  out->bucket = eb.accum / 2;
  out->is_rev = eb.accum % 2;
  out->count = eb.count;
  out->ops = s->ops.data();
  out->lens = s->lens.data();
  out->n_ops = s->n_ops.data();
  out->pos = s->pos.data();
  out->bk = s->bk.data();
  out->bv = s->bv.data();
  out->nb = s->nb.data();
  out->ref_win = sc.resident ? nullptr : s->ref_win.data();
  out->ref_base = s->ref_base.data();
  out->read_seq = sc.resident ? nullptr : s->read_seq.data();
  out->contig_win = (eb.accum % 2) ? s->contig_win.data() : nullptr;
  out->win_base = (eb.accum % 2) ? s->win_base.data() : nullptr;
  out->read_packed = sc.resident ? s->read_packed.data() : nullptr;
  out->ref_chrom = sc.resident ? s->ref_chrom.data() : nullptr;
  return 1;
}

// Intake: write device results back into items (FIFO order — the oldest
// posted batch), then recycle the slot.  Runs on the caller thread while
// the producer keeps prepping; the atomic unresolved decrement publishes
// the result writes to the finisher.
int ptscan_post_results(void* hv, const int32_t* codes, const int32_t* lens,
                        const int32_t* n_out, const int32_t* res_pos,
                        const uint8_t* mapped, const uint8_t* fallback,
                        const int64_t* read_len, long long max_out) {
  auto* h = static_cast<ScannerHandle*>(hv);
  Scanner& sc = h->sc;
  ThreadRole role(&sc.ctr, kMain, false);
  try {
    Scanner::EmittedBatch eb;
    {
      std::lock_guard<std::mutex> lk(sc.q_mu);
      if (sc.posted_q.empty())
        throw std::runtime_error("post_results without pending batch");
      eb = sc.posted_q.front();
      sc.posted_q.pop_front();
    }
    long long tp0 = now_ns();
    Slot& ac = *eb.slot;
    for (int64_t i = 0; i < eb.count; ++i) {
      ReadState& rs = *ac.refs[i].read;
      Item& it = rs.items[ac.refs[i].item];
      if (fallback[i]) {
        sc.fallback_items += 1;
        sc.host_items += 1;
        int64_t opos;
        Cig ocig;
        long long t0 = now_ns();
        bool lifted = host_lift_item(sc, rs, it, &opos, &ocig);
        sc.host_lift_post_ns += now_ns() - t0;
        if (lifted) {
          it.has_result = true;
          it.ref2_pos = opos;
          it.result = std::move(ocig);
        }
      } else if (mapped[i]) {
        // read-length invariant (read_alignment_scanner.rs:204-229)
        if (read_len[i] != (int64_t)rs.rv.l_seq)
          throw std::runtime_error(
              "Failed to remap qname: " + rs.rv.qname + ": seq len " +
              std::to_string(rs.rv.l_seq) +
              " != lifted cigar read len " + std::to_string(read_len[i]));
        it.has_result = true;
        it.ref2_pos = res_pos[i];
        int32_t n = n_out[i];
        it.result.clear();
        it.result.reserve(n);
        for (int32_t j = 0; j < n; ++j)
          it.result.push_back(
              {codes[i * max_out + j], (int64_t)lens[i * max_out + j]});
      }
      it.resolved = true;
      rs.unresolved -= 1;
    }
    sc.t_post_ns += now_ns() - tp0;
    // recycle the slot: its buffers are free to refill the moment this
    // returns (Python drops its array views before calling post_results)
    ac.count = 0;
    ac.refs.clear();
    {
      std::lock_guard<std::mutex> lk(sc.q_mu);
      sc.accums[eb.accum].free_slots.push_back(eb.slot);
    }
    drain_fifo(sc);
    return 0;
  } catch (const std::exception& e) {
    sc.error = e.what();
    return -1;
  }
}

int ptscan_finish(void* hv) {
  auto* h = static_cast<ScannerHandle*>(hv);
  Scanner& sc = h->sc;
  ThreadRole role(&sc.ctr, kMain, false);
  try {
    stop_producer(sc);  // normally already exited (next_batch returned 0)
    if (!sc.prod_error.empty()) throw std::runtime_error(sc.prod_error);
    drain_fifo(sc);
    bool fifo_empty;
    {
      std::lock_guard<std::mutex> flk(sc.fifo_mu);
      fifo_empty = sc.fifo.empty();
    }
    if (!fifo_empty)
      throw std::runtime_error("finish with unresolved reads");
    stop_finisher(sc);
    if (!sc.fin_error.empty()) throw std::runtime_error(sc.fin_error);
    sc.sp_close_remapped.t0 = now_ns();
    if (!ptio_writer_close(sc.remapped)) {
      sc.remapped = nullptr;
      throw std::runtime_error("remapped writer failed");
    }
    sc.remapped = nullptr;
    sc.sp_close_remapped.t1 = sc.sp_close_unassembled.t0 = now_ns();
    if (!ptio_writer_close(sc.unassembled)) {
      sc.unassembled = nullptr;
      throw std::runtime_error("unassembled writer failed");
    }
    sc.unassembled = nullptr;
    sc.sp_close_unassembled.t1 = now_ns();
    // the prep pool and the readahead pool served the producer alone: they
    // end here, so that ptscan_counters reads every thread of the run
    pool_stop(sc.pool);
    ptio_reader_close(sc.reader);
    sc.reader = nullptr;
    return 0;
  } catch (const std::exception& e) {
    sc.error = e.what();
    return -1;
  }
}

void ptscan_stats(void* hv, long long* out6) {
  Scanner& sc = static_cast<ScannerHandle*>(hv)->sc;
  out6[0] = sc.n_primary;
  out6[1] = sc.device_items;
  out6[2] = sc.host_items;
  out6[3] = sc.fallback_items;
  out6[4] = sc.n_unassembled;
  out6[5] = sc.cur_tid;
}

// Wall-clock phase split in ns: [serial record framing/BGZF read,
// parallel prepare_read, parallel fill_item_row, drain handoff, result
// intake, EOF slot padding, finisher encode+write].  Producer fields are
// valid after the producer joins; t_finish after stop_finisher.
void ptscan_timing(void* hv, long long* out9) {
  Scanner& sc = static_cast<ScannerHandle*>(hv)->sc;
  out9[0] = sc.t_read_ns;
  out9[1] = sc.t_prepare_ns;
  out9[2] = sc.t_fill_ns;
  out9[3] = sc.t_drain_ns;
  out9[4] = sc.t_post_ns;
  out9[5] = sc.t_shift_ns;
  out9[6] = sc.t_finish_ns;
  out9[7] = sc.t_fin_encode_ns;
  out9[8] = sc.t_fin_write_ns;
}

// The run's counters as one JSON object: "wait_ns" {"<site>@<role>": [ns,
// waits]} for the waits that blocked, "cpu_ns" {role: ns} for the threads
// the run started, "host_lift_ns" {"prep", "post"}, "deflate_blocks"
// {"card", "host"} and "deflate_launches" of the two writers, and "spans"
// [[name, t0, t1]] of the native threads on CLOCK_MONOTONIC.  Complete after a
// successful ptscan_finish, which has joined every thread of the run; the
// text lives until the next call or ptscan_destroy.
const char* ptscan_counters(void* hv) {
  Scanner& sc = static_cast<ScannerHandle*>(hv)->sc;
  std::ostringstream o;
  std::lock_guard<std::mutex> lk(sc.ctr.mu);
  o << "{\"wait_ns\": {";
  const char* sep = "";
  for (const Counters::Wait& w : sc.ctr.waits) {
    o << sep << '"' << w.site << '@' << kRoleNames[w.role] << "\": [" << w.ns
      << ", " << w.n << ']';
    sep = ", ";
  }
  o << "}, \"cpu_ns\": {";
  for (int r = kMain + 1; r < kRoles; ++r)
    o << (r > kMain + 1 ? ", " : "") << '"' << kRoleNames[r]
      << "\": " << sc.ctr.cpu_ns[r];
  o << "}, \"host_lift_ns\": {\"prep\": " << sc.host_lift_prep_ns.load()
    << ", \"post\": " << sc.host_lift_post_ns
    << "}, \"deflate_blocks\": {\"card\": " << sc.ctr.deflate_card.load()
    << ", \"host\": " << sc.ctr.deflate_host.load()
    << "}, \"deflate_launches\": " << sc.ctr.deflate_launches.load()
    << ", \"spans\": [";
  const std::pair<const char*, Scanner::Span> spans[] = {
      {"producer", sc.sp_producer},
      {"producer.first_slot", {sc.sp_producer.t0, sc.first_slot_ns}},
      {"finisher", sc.sp_finisher},
      {"writer.close.remapped", sc.sp_close_remapped},
      {"writer.close.unassembled", sc.sp_close_unassembled}};
  sep = "";
  for (const auto& [name, sp] : spans)
    if (sp.t0 && sp.t1) {
      o << sep << "[\"" << name << "\", " << sp.t0 << ", " << sp.t1 << ']';
      sep = ", ";
    }
  o << "]}";
  sc.counters_json = o.str();
  return sc.counters_json.c_str();
}

void ptscan_destroy(void* hv) {
  auto* h = static_cast<ScannerHandle*>(hv);
  stop_producer(h->sc);  // must stop before slots/fifo are destroyed
  pool_stop(h->sc.pool);
  stop_finisher(h->sc);  // must stop before the writers close
  if (h->sc.reader) ptio_reader_close(h->sc.reader);
  if (h->sc.remapped) ptio_writer_close(h->sc.remapped);
  if (h->sc.unassembled) ptio_writer_close(h->sc.unassembled);
  delete h;
}


// ---- phase-1 exports (contig_scan native walk) ----

typedef struct {
  long long n_rec;
  const int64_t* rec;   // 9/record: kind, tid, contig, seg_start, seg_count,
                        // rev_off(-1 none), rev_len, qname_off, qname_len
  long long n_seg;
  const int64_t* seg;   // 11/segment: so_start, so_end, chrom, pos, is_fwd,
                        // mapq, from_primary, cig_off(pairs), cig_n,
                        // bm_off, bm_n  (supp rows: so_start/so_end carry
                        // the match-key clip fields)
  const int64_t* cig;   // (code, len) pairs
  long long n_cig;      // in pairs
  const int64_t* bmk;
  const int64_t* bmv;
  long long n_bm;
  const uint8_t* rev;
  long long n_rev;
  const uint8_t* qname;
  long long n_qname;
} PtscanP1Out;

void* ptscan_p1_create(long long n_ref, const char* ref_names_cat,
                       const int64_t* ref_off, long long n_ctg,
                       const char* ctg_names_cat, const int64_t* ctg_off,
                       int n_threads) {
  auto* h = new P1Handle();
  for (long long i = 0; i < n_ref; ++i)
    h->ref_idx.emplace(
        std::string(ref_names_cat + ref_off[i],
                    ref_names_cat + ref_off[i + 1]),
        (int32_t)i);
  for (long long i = 0; i < n_ctg; ++i)
    h->ctg_idx.emplace(
        std::string(ctg_names_cat + ctg_off[i],
                    ctg_names_cat + ctg_off[i + 1]),
        (int32_t)i);
  h->pool_threads = n_threads;
  pool_start(h->pool, n_threads);
  return h;
}

const char* ptscan_p1_error(void* hv) {
  return static_cast<P1Handle*>(hv)->error.c_str();
}

// Process one chunk of raw BAM record payloads (concatenated; offs has n+1
// entries).  Returns 0 / -1 (message via ptscan_p1_error).  Parallel across
// records on the handle's pool; outputs flatten in input order.
int ptscan_p1_process(void* hv, const uint8_t* raw_cat, const int64_t* offs,
                      long long n) {
  auto* h = static_cast<P1Handle*>(hv);
  h->error.clear();
  h->recs.assign(n, P1Rec());
  pool_run(h->pool, n, [&](int64_t i) {
    P1Rec& r = h->recs[i];
    try {
      p1_process_one(*h, raw_cat + offs[i], (size_t)(offs[i + 1] - offs[i]),
                     &r);
    } catch (const std::exception& e) {
      r.err = e.what();
      if (r.err.empty()) r.err = "phase-1 record processing failed";
    }
  });
  for (long long i = 0; i < n; ++i) {
    if (!h->recs[i].err.empty()) {
      h->error = h->recs[i].err;
      return -1;
    }
  }
  // flatten (input order)
  h->o_rec.clear();
  h->o_seg.clear();
  h->o_cig.clear();
  h->o_bmk.clear();
  h->o_bmv.clear();
  h->o_rev.clear();
  h->o_qname.clear();
  h->o_rec.reserve(9 * n);
  for (long long i = 0; i < n; ++i) {
    P1Rec& r = h->recs[i];
    int64_t seg_start = (int64_t)(h->o_seg.size() / 11);
    int64_t rev_off = -1, rev_len = 0;
    if (r.has_rev) {
      rev_off = (int64_t)h->o_rev.size();
      rev_len = (int64_t)r.rev.size();
      h->o_rev.insert(h->o_rev.end(), r.rev.begin(), r.rev.end());
    }
    int64_t q_off = (int64_t)h->o_qname.size();
    h->o_qname.insert(h->o_qname.end(), r.qname.begin(), r.qname.end());
    h->o_rec.push_back(r.kind);
    h->o_rec.push_back(r.tid);
    h->o_rec.push_back(r.contig);
    h->o_rec.push_back(seg_start);
    h->o_rec.push_back((int64_t)r.segs.size());
    h->o_rec.push_back(rev_off);
    h->o_rec.push_back(rev_len);
    h->o_rec.push_back(q_off);
    h->o_rec.push_back((int64_t)r.qname.size());
    for (size_t si = 0; si < r.segs.size(); ++si) {
      const SegView& sg = r.segs[si];
      int64_t cig_off = (int64_t)(h->o_cig.size() / 2);
      for (const Op& o : sg.cigar) {
        h->o_cig.push_back(o.code);
        h->o_cig.push_back(o.len);
      }
      int64_t bm_off = (int64_t)h->o_bmk.size();
      h->o_bmk.insert(h->o_bmk.end(), r.bm_keys[si].begin(),
                      r.bm_keys[si].end());
      h->o_bmv.insert(h->o_bmv.end(), r.bm_vals[si].begin(),
                      r.bm_vals[si].end());
      int64_t f0 = sg.so_start, f1 = sg.so_end;
      if (r.kind == 2) {
        f0 = r.supp_clip0;
        f1 = r.supp_clip1;
      }
      const int64_t row[11] = {
          f0, f1, (int64_t)sg.chrom, sg.pos, sg.fwd ? 1 : 0,
          (int64_t)sg.mapq, sg.from_primary ? 1 : 0, cig_off,
          (int64_t)sg.cigar.size(), bm_off,
          (int64_t)r.bm_keys[si].size()};
      h->o_seg.insert(h->o_seg.end(), row, row + 11);
    }
  }
  h->recs.clear();
  return 0;
}

void ptscan_p1_results(void* hv, PtscanP1Out* out) {
  auto* h = static_cast<P1Handle*>(hv);
  out->n_rec = (long long)(h->o_rec.size() / 9);
  out->rec = h->o_rec.data();
  out->n_seg = (long long)(h->o_seg.size() / 11);
  out->seg = h->o_seg.data();
  out->cig = h->o_cig.data();
  out->n_cig = (long long)(h->o_cig.size() / 2);
  out->bmk = h->o_bmk.data();
  out->bmv = h->o_bmv.data();
  out->n_bm = (long long)h->o_bmk.size();
  out->rev = h->o_rev.data();
  out->n_rev = (long long)h->o_rev.size();
  out->qname = h->o_qname.data();
  out->n_qname = (long long)h->o_qname.size();
}

void ptscan_p1_destroy(void* hv) {
  auto* h = static_cast<P1Handle*>(hv);
  pool_stop(h->pool);
  delete h;
}

// Debug/fuzz surface for the seq nibble codecs (tests/test_simd_codecs.py
// pins the SIMD forms byte-for-byte to the scalar walks across lengths).
// mode 0: forward decode (packed -> ASCII), out needs l_seq bytes.
// mode 1: reverse-complement decode, out needs l_seq bytes.
// mode 2: flip re-pack (packed -> revcomp packed), out needs
//         (l_seq+1)/2 bytes — the finisher's flipped-seq encode.
void ptscan_dbg_seqcodec(int mode, const uint8_t* packed, long long l_seq,
                         uint8_t* out) {
  if (mode == 0) {
    decode_seq_into(packed, l_seq, out);
  } else if (mode == 1) {
    decode_seq_rc_into(packed, l_seq, out);
  } else {
    repack_seq_rc(packed, l_seq, out);
  }
}

// Stress/regression surface for the WorkPool epoch handoff
// (tests/test_native_feed.py::test_pool_epoch_stress).  Alternates two
// DIFFERENT epoch bodies over rapid tiny epochs: the round-5 stale-worker
// bug (a worker that slept through epoch E waking after E completed, reading
// the dead fn pointer, then claiming ticket 0 of epoch E+1 once `next` was
// reset — invoking the destroyed closure: the wandering RA>=2 suite
// corruption) executes body A during a B epoch, which the per-item `who`
// check below catches even in an uninstrumented build (ASAN flags the dead
// closure invocation itself).  Returns 0 when every item of every epoch ran
// exactly its own epoch's body.
int ptscan_dbg_pool_stress(int n_threads, long long epochs) {
  WorkPool pool;
  pool_start(pool, n_threads < 2 ? 2 : n_threads);
  std::vector<std::atomic<uint8_t>> who(16);
  long long bad = 0;
  for (long long e = 0; e < epochs; ++e) {
    int n = 2 + (int)(e % 5);  // >=2: n==1 runs inline, no handoff
    for (int i = 0; i < n; ++i) who[i].store(0, std::memory_order_relaxed);
    // fresh std::function temporaries each call, at the same stack slot —
    // the production pattern (producer_main's per-iteration lambdas)
    if ((e & 1) == 0) {
      pool_run(pool, n, [&](int64_t i) {
        who[i].store(1, std::memory_order_relaxed);
      });
    } else {
      pool_run(pool, n, [&](int64_t i) {
        who[i].store(2, std::memory_order_relaxed);
      });
    }
    uint8_t want = (e & 1) == 0 ? 1 : 2;
    for (int i = 0; i < n; ++i)
      if (who[i].load(std::memory_order_relaxed) != want) ++bad;
  }
  pool_stop(pool);
  return bad == 0 ? 0 : 1;
}

}  // extern "C"
