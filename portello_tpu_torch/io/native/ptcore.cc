// ptcore: native (C++) implementation of the per-read liftover inner loop.
//
// Reference-exact port of the phase-2 hot path the Rust binary runs per
// work item — liftover_read_alignment (reference
// src/liftover_read_alignment.rs:35-223) followed by
// simplify_alignment_indels (src/simplify_alignment_indels.rs:4-156) with the
// clean_up_cigar_edge_indels + compress_cigar finishing pair
// (lib/rust-vc-utils/src/bam_utils/cigar/mod.rs:204-291).
//
// Two roles:
//  1. BASELINE PROXY (BASELINE.md): no Rust toolchain exists in this image,
//     so this measures what a compiled multithreaded CPU implementation of
//     the same per-read algorithm achieves — the honest denominator for the
//     TPU reads/s/chip headline.
//  2. Fast host path: a native alternative to the Python oracle for
//     fallback items (bit-identical; enforced by tests/test_native_core.py).
//
// C ABI consumed via ctypes (portello_tpu/ops/native_core.py).
// Build: g++ -O3 -std=c++17 -shared -fPIC ptcore.cc -o ptcore.so -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// BAM op codes (SAM spec 4.2; portello_tpu/ops/cigar.py)
constexpr int kM = 0, kI = 1, kD = 2, kN = 3, kS = 4, kH = 5, kP = 6,
              kEq = 7, kX = 8;

inline bool is_align_match(int c) { return c == kM || c == kEq || c == kX; }
inline bool consumes_ref(int c) {
  return c == kM || c == kD || c == kN || c == kEq || c == kX;
}
inline bool consumes_read_hard(int c) {
  return c == kM || c == kI || c == kS || c == kH || c == kEq || c == kX;
}

struct Op {
  int32_t code;
  int64_t len;
};

// clean_up_cigar_edge_indels (cigar/mod.rs:265-291): edge Ins -> SoftClip,
// edge Del -> dropped (zero-length SoftClip), returns leading-del shift.
// Followed in place by compress_cigar (cigar/mod.rs:204-228).
int64_t cleanup_and_compress(std::vector<Op>* cig) {
  int64_t n = static_cast<int64_t>(cig->size());
  int64_t first = n, last = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (is_align_match((*cig)[i].code)) {
      if (first == n) first = i;
      last = i;
    }
  }
  int64_t shift = 0;
  for (int64_t i = 0; i < n; ++i) {
    Op& op = (*cig)[i];
    bool edge = i < first || i > last;
    if (!edge) continue;
    if (op.code == kD) {
      if (i < first) shift += op.len;
      op.code = kS;
      op.len = 0;
    } else if (op.code == kI) {
      op.code = kS;
    }
  }
  // compress: drop zero-length, merge adjacent equal codes
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const Op& op = (*cig)[i];
    if (op.len == 0) continue;
    if (w > 0 && (*cig)[w - 1].code == op.code) {
      (*cig)[w - 1].len += op.len;
    } else {
      (*cig)[w++] = op;
    }
  }
  cig->resize(w);
  return shift;
}

// liftover_read_alignment (liftover_read_alignment.rs:137-223).  Returns
// false when no read base lands on ref2 (unmapped).  The block map window
// (bk/bv, nb entries, vals -1 = gap) must cover the alignment span exactly
// as BlockMap.get_ref_range would return it.
bool liftover_one(const int32_t* ops, const int32_t* lens, int64_t n_ops,
                  int64_t ref1_pos, const int32_t* bk, const int32_t* bv,
                  int64_t nb, std::vector<Op>* out, int64_t* ref2_pos) {
  bool have_start = false, have_end = false;
  int64_t ref2_start = 0, ref2_end = 0;
  int64_t seg_start = ref1_pos;
  out->clear();
  for (int64_t oi = 0; oi < n_ops; ++oi) {
    int code = ops[oi];
    int64_t length = lens[oi];
    if (code == kI || code == kS || code == kH) {
      out->push_back({static_cast<int32_t>(code), length});
    } else if (code == kP) {
      // dropped
    } else {
      int64_t seg_end = seg_start + length;
      bool match = is_align_match(code);
      // get_ref_range floor semantics (read_to_ref_map.rs:74-85)
      int64_t lo =
          std::upper_bound(bk, bk + nb, seg_start) - bk - 1;
      if (lo < 0) lo = 0;
      int64_t hi = std::lower_bound(bk, bk + nb, seg_end) - bk;
      int64_t block_pos = seg_start;
      bool have_last = false;
      int64_t last_key = 0, last_val = 0;
      for (int64_t i = lo; i <= hi; ++i) {
        bool has_this = i < hi;
        int64_t end =
            has_this ? std::min<int64_t>(bk[i], seg_end) : seg_end;
        if (end > block_pos) {
          int64_t seg_len = end - block_pos;
          if (!have_last) {
            if (match) out->push_back({kS, seg_len});
          } else if (last_val < 0) {  // gap block: ref1 deleted in ref2
            if (match) out->push_back({kI, seg_len});
          } else {
            if (match && !have_start) {
              have_start = true;
              ref2_start = last_val + (block_pos - last_key);
            }
            if (have_end) {
              int64_t dl = last_val - ref2_end;
              if (dl > 0 && have_start) out->push_back({kD, dl});
            }
            ref2_end = last_val + (end - last_key);
            have_end = true;
            if (match || have_start) {
              int c = code == kD ? kD : (code == kN ? kN : kM);
              out->push_back({static_cast<int32_t>(c), seg_len});
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
  *ref2_pos = ref2_start + cleanup_and_compress(out);
  return true;
}

// ---- homology + left shift (ops/homology.py, ops/shift.py; reference
//      indel_breakend_homology.rs:24-73, shift_indels/) ----

int64_t homology_left(const uint8_t* ref_seq, int64_t ref_len,
                      const uint8_t* read_seq, int64_t read_len,
                      int64_t ref_start, int64_t ref_end, int64_t read_start,
                      int64_t read_end) {
  (void)ref_len;
  (void)read_len;
  int64_t max_left = std::min(ref_start, read_start);
  int64_t left = 0;
  while (left < max_left &&
         ref_seq[ref_end - left - 1] == read_seq[read_end - left - 1])
    ++left;
  return left;
}

// left_shift_indels (shift_indels/left_shift_indels.rs:17-39 +
// cigar_indel_shifter.rs:10-165); returns shifted (pos, cigar) after the
// cleanup+compress finishing pair.
void left_shift_indels_native(int64_t ref_pos, const std::vector<Op>& cig,
                              const uint8_t* ref_seq, int64_t ref_len,
                              const uint8_t* read_seq, int64_t read_len,
                              int64_t* out_pos, std::vector<Op>* out) {
  int64_t match_block = 0;
  bool in_indel = false;
  int64_t i_ref = 0, i_read = 0, i_del = 0, i_ins = 0;
  out->clear();

  auto end_indel = [&]() {
    if (!in_indel) return;
    in_indel = false;
    int64_t left = homology_left(ref_seq, ref_len, read_seq, read_len, i_ref,
                                 i_ref + i_del, i_read, i_read + i_ins);
    int64_t shift_len = left;  // LEFT direction: max(0, -(-left))
    int64_t actual = std::min(match_block, shift_len);
    int64_t remaining = match_block - actual;
    if (remaining > 0) out->push_back({kM, remaining});
    match_block = actual;
    if (i_ins > 0) out->push_back({kI, i_ins});
    if (i_del > 0) out->push_back({kD, i_del});
    i_ins = i_del = 0;
  };
  auto add_other = [&](const Op* seg) {
    end_indel();
    if (match_block > 0) {
      out->push_back({kM, match_block});
      match_block = 0;
    }
    if (seg) out->push_back(*seg);
  };

  int64_t rp = ref_pos, dp = 0;
  for (const Op& o : cig) {
    if (o.code == kD) {
      if (o.len > 0) {
        if (!in_indel) {
          i_ref = rp;
          i_read = dp;
          in_indel = true;
        }
        i_del += o.len;
      }
    } else if (o.code == kI) {
      if (o.len > 0) {
        if (!in_indel) {
          i_ref = rp;
          i_read = dp;
          in_indel = true;
        }
        i_ins += o.len;
      }
    } else if (is_align_match(o.code)) {
      end_indel();
      match_block += o.len;
    } else {
      add_other(&o);
    }
    if (consumes_ref(o.code)) rp += o.len;
    if (consumes_read_hard(o.code)) dp += o.len;
  }
  add_other(nullptr);
  *out_pos = ref_pos + cleanup_and_compress(out);
}

// _end_indel (simplify_alignment_indels.rs:35-111): greedy right-edge then
// left-edge re-match against actual sequence, SNP preference.
void end_indel(const uint8_t* ref_seq, const uint8_t* read_seq,
               int64_t bref, int64_t bread, int64_t del_len, int64_t ins_len,
               std::vector<Op>* out) {
  if (del_len == 0 && ins_len == 0) return;
  if (del_len == 0) {
    out->push_back({kI, ins_len});
    return;
  }
  if (ins_len == 0) {
    out->push_back({kD, del_len});
    return;
  }
  if (del_len == 1 && ins_len == 1) {
    out->push_back({kM, 1});
    return;
  }
  int64_t pre = 0, post = 0;
  while (del_len > 0 && ins_len > 0 &&
         ref_seq[bref + del_len - 1] == read_seq[bread + ins_len - 1]) {
    --del_len;
    --ins_len;
    ++post;
  }
  while (del_len > 0 && ins_len > 0 &&
         ref_seq[bref + pre] == read_seq[bread + pre]) {
    --del_len;
    --ins_len;
    ++pre;
  }
  if (del_len == 1 && ins_len == 1) {
    del_len = 0;
    ins_len = 0;
    ++post;
  }
  if (pre) out->push_back({kM, pre});
  if (ins_len) out->push_back({kI, ins_len});
  if (del_len) out->push_back({kD, del_len});
  if (post) out->push_back({kM, post});
}

// simplify_alignment_indels (simplify_alignment_indels.rs:119-156);
// ref_pos indexes ref_seq directly (window-relative).
int64_t simplify_one(int64_t ref_pos, const std::vector<Op>& cig,
                     const uint8_t* ref_seq, const uint8_t* read_seq,
                     std::vector<Op>* out) {
  int64_t ref_head = ref_pos, read_head = 0;
  bool in_block = false;
  int64_t bref = 0, bread = 0, bdel = 0, bins = 0;
  out->clear();
  for (const Op& op : cig) {
    if (op.code == kD || op.code == kI) {
      if (!in_block) {
        in_block = true;
        bref = ref_head;
        bread = read_head;
      }
      if (op.code == kD)
        bdel += op.len;
      else
        bins += op.len;
    } else {
      if (in_block) {
        end_indel(ref_seq, read_seq, bref, bread, bdel, bins, out);
        in_block = false;
        bdel = bins = 0;
      }
      out->push_back(op);
    }
    if (consumes_ref(op.code)) ref_head += op.len;
    if (consumes_read_hard(op.code)) read_head += op.len;
  }
  if (in_block) end_indel(ref_seq, read_seq, bref, bread, bdel, bins, out);
  return ref_pos + cleanup_and_compress(out);
}

struct BatchArgs {
  int64_t b;
  const int32_t* ops;
  const int32_t* lens;
  const int32_t* n_ops;
  int64_t max_ops;
  const int32_t* pos;
  const int32_t* bk;
  const int32_t* bv;
  const int32_t* nb;
  int64_t max_blocks;
  const uint8_t* ref_win;
  const int32_t* ref_base;
  const uint8_t* read_seq;
  int64_t max_seq;
  int32_t* out_codes;
  int32_t* out_lens;
  int32_t* out_n;
  int32_t* out_pos;
  int64_t max_out;
};

void run_range(const BatchArgs& a, int64_t i0, int64_t i1) {
  std::vector<Op> lifted, simplified;
  lifted.reserve(a.max_out * 2);
  simplified.reserve(a.max_out * 2);
  for (int64_t i = i0; i < i1; ++i) {
    const int32_t* ops = a.ops + i * a.max_ops;
    const int32_t* lens = a.lens + i * a.max_ops;
    const int32_t* bk = a.bk + i * a.max_blocks;
    const int32_t* bv = a.bv + i * a.max_blocks;
    int64_t ref2_pos = 0;
    if (!liftover_one(ops, lens, a.n_ops[i], a.pos[i], bk, bv, a.nb[i],
                      &lifted, &ref2_pos)) {
      a.out_n[i] = -1;
      a.out_pos[i] = -1;
      continue;
    }
    int64_t rel = ref2_pos - a.ref_base[i];
    int64_t new_rel = simplify_one(rel, lifted, a.ref_win + i * a.max_seq,
                                   a.read_seq + i * a.max_seq, &simplified);
    int64_t n = static_cast<int64_t>(simplified.size());
    if (n > a.max_out) {
      a.out_n[i] = -2;  // overflow: caller must widen max_out
      a.out_pos[i] = -1;
      continue;
    }
    for (int64_t j = 0; j < n; ++j) {
      a.out_codes[i * a.max_out + j] = simplified[j].code;
      a.out_lens[i * a.max_out + j] =
          static_cast<int32_t>(simplified[j].len);
    }
    a.out_n[i] = static_cast<int32_t>(n);
    a.out_pos[i] = static_cast<int32_t>(a.ref_base[i] + new_rel);
  }
}

}  // namespace

extern "C" {

// Lift + simplify a batch of work items (fixed-stride padded layout, the
// exact layout DeviceEngine._run_group builds).  n_threads > 1 splits the
// batch across worker threads.  out_n[i]: -1 unmapped, -2 overflow, else op
// count.  Returns 0 on success.
long long ptcore_lift_simplify_batch(
    long long b, const int32_t* ops, const int32_t* lens,
    const int32_t* n_ops, long long max_ops, const int32_t* pos,
    const int32_t* bk, const int32_t* bv, const int32_t* nb,
    long long max_blocks, const uint8_t* ref_win, const int32_t* ref_base,
    const uint8_t* read_seq, long long max_seq, int n_threads,
    int32_t* out_codes, int32_t* out_lens, int32_t* out_n, int32_t* out_pos,
    long long max_out) {
  BatchArgs a{b,       ops,     lens,     n_ops,    max_ops,  pos,
              bk,      bv,      nb,       max_blocks, ref_win, ref_base,
              read_seq, max_seq, out_codes, out_lens, out_n,   out_pos,
              max_out};
  if (n_threads <= 1 || b < 2) {
    run_range(a, 0, b);
    return 0;
  }
  int nt = std::min<long long>(n_threads, b);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    int64_t i0 = b * t / nt, i1 = b * (t + 1) / nt;
    pool.emplace_back([&a, i0, i1] { run_range(a, i0, i1); });
  }
  for (auto& th : pool) th.join();
  return 0;
}

int ptcore_hw_threads() {
  return static_cast<int>(std::thread::hardware_concurrency());
}

// Batch left-shift (the rev-item host-shift prep step; reference
// read_alignment_scanner.rs:159-176 + shift_indels/).  Positions are
// RELATIVE to the per-row contig window (contig_win must cover
// [0, pos+ref_span) of the reversed contig).  out_n[i]: -2 overflow, else op
// count; out_pos[i] = shifted relative pos.  Returns 0 on success.
long long ptcore_shift_batch(
    long long b, const int32_t* ops, const int32_t* lens,
    const int32_t* n_ops, long long max_ops, const int32_t* pos,
    const uint8_t* contig_win, const uint8_t* read_seq, long long max_seq,
    int n_threads, int32_t* out_codes, int32_t* out_lens, int32_t* out_n,
    int32_t* out_pos, long long max_out) {
  auto run = [&](int64_t i0, int64_t i1) {
    std::vector<Op> cig, shifted;
    for (int64_t i = i0; i < i1; ++i) {
      cig.clear();
      for (int64_t j = 0; j < n_ops[i]; ++j)
        cig.push_back({ops[i * max_ops + j], (int64_t)lens[i * max_ops + j]});
      int64_t spos = 0;
      left_shift_indels_native(pos[i], cig, contig_win + i * max_seq, max_seq,
                               read_seq + i * max_seq, max_seq, &spos,
                               &shifted);
      int64_t n = (int64_t)shifted.size();
      if (n > max_out) {
        out_n[i] = -2;
        out_pos[i] = -1;
        continue;
      }
      for (int64_t j = 0; j < n; ++j) {
        out_codes[i * max_out + j] = shifted[j].code;
        out_lens[i * max_out + j] = (int32_t)shifted[j].len;
      }
      out_n[i] = (int32_t)n;
      out_pos[i] = (int32_t)spos;
    }
  };
  if (n_threads <= 1 || b < 2) {
    run(0, b);
    return 0;
  }
  int nt = std::min<long long>(n_threads, b);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    int64_t i0 = b * t / nt, i1 = b * (t + 1) / nt;
    pool.emplace_back([&run, i0, i1] { run(i0, i1); });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
