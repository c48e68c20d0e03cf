// ptio: native BGZF/BAM codec for portello-tpu.
//
// Replaces the role htslib (C) plays in the reference stack
// (reference Cargo.toml:20 via rust-htslib): BGZF block inflate for indexed
// BAM reads, bulk record scanning, and pool-threaded BGZF deflate for BAM
// output (the reference gives htslib max(1, threads/2) compression threads,
// read_alignment_scanner.rs:589).
//
// Exposed as a C ABI consumed by ctypes (portello_tpu/io/native_codec.py).
// Build: g++ -O3 -std=c++17 -shared -fPIC ptio.cc -o ptio.so -lz -lpthread

#include <zlib.h>

#include "../../csrc/bgzf_deflate.h"

// libdeflate: the same accelerated codec htslib links for BGZF when
// available (2-3x zlib on both directions + PCLMUL crc32).  Falls back to
// zlib when the header or library is absent (-DPTIO_NO_LIBDEFLATE).
#if !defined(PTIO_NO_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define PTIO_HAVE_LIBDEFLATE 1
#endif

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Watchdog condvar wait: identical blocking semantics, but after each 120 s
// without the predicate it logs WHERE it is stuck plus a caller-supplied
// state line, then keeps waiting.  Converts any future lost-wakeup /
// deadlock (ROUND5.md flake note) into a self-diagnosing stderr report
// instead of a silent hang.  PTPU_WATCHDOG_SECS overrides the period
// (test harnesses shorten it to capture diagnoses quickly).
inline int wd_secs() {
  static int v = [] {
    const char* e = getenv("PTPU_WATCHDOG_SECS");
    int n = e ? atoi(e) : 120;
    return n > 0 ? n : 120;
  }();
  return v;
}

// The clock of every span and wait: CLOCK_MONOTONIC, the clock Python's
// time.monotonic_ns reads, so the scanner's spans and its caller's share
// one timeline.
inline long long now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

inline long long thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

// Where one scanner run's threads wait and what CPU they use.  Each thread
// names its role once (ThreadRole); a wd_wait that blocks adds its time
// under (site, role), and each thread the run started adds its CPU time
// when it ends.  A thread with no counters (ptio's own C exports, a
// caller's feeder thread) counts nothing.
enum Role { kMain, kProducer, kPrep, kReadahead, kFinisher, kDeflate,
            kWriterIo, kRoles };
constexpr const char* kRoleNames[kRoles] = {
    "main", "producer", "prep", "readahead", "finisher", "deflate",
    "writer_io"};

struct Counters {
  struct Wait {
    const char* site;
    int role;
    long long ns, n;
  };
  std::mutex mu;  // a leaf lock: taken with no other lock acquired inside
  std::vector<Wait> waits;  // a few sites x roles: searched linearly
  long long cpu_ns[kRoles] = {};
  // BGZF blocks the writers deflated on the card and on the host, and the
  // card's launches
  std::atomic<long long> deflate_card{0}, deflate_host{0}, deflate_launches{0};

  void add_wait(const char* site, int role, long long ns) {
    std::lock_guard<std::mutex> lk(mu);
    for (Wait& w : waits)
      if (w.role == role && std::strcmp(w.site, site) == 0) {
        w.ns += ns;
        ++w.n;
        return;
      }
    waits.push_back({site, role, ns, 1});
  }
};

thread_local Counters* tl_counters = nullptr;
thread_local int tl_role = kMain;

// The calling thread's role and counters while in scope.  A thread the run
// started (`own`) holds one for its whole life and adds its CPU time at the
// end; the caller's thread holds one per call into the scanner and keeps
// its CPU time out (the caller reads its own).
//
// Its constructor writes this library's thread-locals, so each pool thread
// (readahead, deflate, writer io) touches them as it starts, before its
// first job.  Keep that first touch at the start of those threads: on an
// H100 host (8 cores, zlib) a feed whose pool threads first touched them
// inside a job, or never, lifted reads 1.3-2.1x slower and used more CPU
// seconds a call, whether or not the roles counted anything; why is not
// known yet (PERF.md, Open questions).
class ThreadRole {
 public:
  ThreadRole(Counters* c, int role, bool own = true)
      : prev_(tl_counters), prev_role_(tl_role), own_(own && c) {
    tl_counters = c;
    tl_role = role;
  }
  ~ThreadRole() {
    if (own_) {
      std::lock_guard<std::mutex> lk(tl_counters->mu);
      tl_counters->cpu_ns[tl_role] += thread_cpu_ns();
    }
    tl_counters = prev_;
    tl_role = prev_role_;
  }
  ThreadRole(const ThreadRole&) = delete;
  ThreadRole& operator=(const ThreadRole&) = delete;

 private:
  Counters* prev_;
  int prev_role_;
  bool own_;
};

// A wait whose predicate is false on entry is timed into the thread's
// counters; one that does not block reads no clock.
template <typename Pred, typename Dump>
void wd_wait(std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
             const char* site, Pred pred, Dump dump) {
  if (pred()) return;
  Counters* c = tl_counters;
  long long t0 = c ? now_ns() : 0;
  int rounds = 0;
  while (!cv.wait_for(lk, std::chrono::seconds(wd_secs()), pred)) {
    ++rounds;
    fprintf(stderr, "[ptscan-watchdog] '%s' blocked %ds: %s\n", site,
            rounds * wd_secs(), dump().c_str());
    fflush(stderr);
  }
  if (c) c->add_wait(site, tl_role, now_ns() - t0);
}

constexpr uint8_t kEofMarker[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

struct DecodedBlock {
  std::vector<uint8_t> data;
  uint32_t csize = 0;
};

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  // current virtual position
  size_t coffset = 0;
  uint32_t uoffset = 0;
  // cached inflated block
  size_t block_coffset = SIZE_MAX;
  uint32_t block_csize = 0;
  std::vector<uint8_t> block;
  std::string error;
  // Async parallel readahead (sequential scans; BGZF blocks are
  // independent): a persistent worker pool inflates blocks AHEAD of the
  // cursor into ra_cache while the consumer keeps scanning — the old
  // fork-join batch stalled the consumer for every ~4 MB window and paid
  // thread spawn/join per batch.
  int n_threads = 1;
  std::unordered_map<size_t, DecodedBlock> ra_cache;   // decoded, not taken
  std::vector<std::thread> ra_pool;
  std::mutex ra_mu;
  std::condition_variable ra_work_cv, ra_done_cv;
  std::deque<std::pair<size_t, uint32_t>> ra_todo;     // (coffset, bsize)
  std::unordered_set<size_t> ra_pending;               // queued or decoding
  bool ra_closing = false;
  size_t ra_next = 0;  // next coffset not yet scheduled
  Counters* ctr = nullptr;  // set before the readahead pool starts
  // Push mode (direct CRAM streaming, no temp-BAM transcode): an external
  // producer thread pushes UNCOMPRESSED BAM bytes through a bounded queue
  // and reader_read drains it; the mmap/BGZF machinery above is unused.
  // The producer must have exited before ptio_reader_close runs.
  bool push_mode = false;
  std::deque<std::vector<uint8_t>> push_q;
  size_t push_front_off = 0;  // consumed bytes of push_q.front()
  size_t push_buffered = 0;
  size_t push_cap = 64ull << 20;
  bool push_eof = false;
  bool push_closed = false;  // producer-side failure or consumer abort
  std::mutex push_mu;
  std::condition_variable push_cv_data, push_cv_space;
};

// Parse a BGZF block header at coffset; returns BSIZE or 0 with *err set.
uint32_t block_bsize(const Reader* r, size_t coffset, std::string* err) {
  if (coffset + 18 > r->size) {
    *err = "truncated BGZF block header";
    return 0;
  }
  const uint8_t* p = r->data + coffset;
  if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4)) {
    *err = "not a BGZF block";
    return 0;
  }
  uint16_t xlen;
  std::memcpy(&xlen, p + 10, 2);
  // the extra field must be fully mapped BEFORE scanning it: a truncated
  // tail with garbage xlen would walk up to 64KB past the mapping (SIGBUS
  // on a page boundary, inside a readahead worker)
  if (coffset + 12 + (size_t)xlen > r->size) {
    *err = "truncated BGZF block header";
    return 0;
  }
  uint32_t bsize = 0;
  size_t xs = 12, xend = 12 + xlen;
  while (xs + 4 <= xend) {
    uint16_t slen;
    std::memcpy(&slen, p + xs + 2, 2);
    if (p[xs] == 'B' && p[xs + 1] == 'C' && slen == 2) {
      uint16_t bs;
      std::memcpy(&bs, p + xs + 4, 2);
      bsize = static_cast<uint32_t>(bs) + 1;
    }
    xs += 4 + slen;
  }
  // bsize must cover header (12+xlen), some deflate payload, and the
  // 8-byte CRC/ISIZE trailer — otherwise avail_in below would underflow
  if (bsize < 12 + (uint32_t)xlen + 8 || coffset + bsize > r->size) {
    *err = "BGZF block missing/invalid BSIZE";
    return 0;
  }
  return bsize;
}

// Inflate the block at coffset (pure function of the mmap; thread-safe).
bool inflate_block(const Reader* r, size_t coffset, uint32_t bsize,
                   std::vector<uint8_t>* out, std::string* err) {
  const uint8_t* p = r->data + coffset;
  uint16_t xlen;
  std::memcpy(&xlen, p + 10, 2);
  uint32_t isize;
  std::memcpy(&isize, p + bsize - 4, 4);
  if (isize > 65536) {  // BGZF spec: uncompressed block size <= 64 KiB
    *err = "BGZF block ISIZE exceeds the 64 KiB spec limit";
    return false;
  }
  out->resize(isize);
  if (isize > 0) {
#ifdef PTIO_HAVE_LIBDEFLATE
    static thread_local libdeflate_decompressor* dec =
        libdeflate_alloc_decompressor();
    size_t actual = 0;
    if (libdeflate_deflate_decompress(dec, p + 12 + xlen,
                                      bsize - 12 - xlen - 8, out->data(),
                                      isize, &actual) != LIBDEFLATE_SUCCESS ||
        actual != isize) {
      *err = "BGZF inflate failed";
      return false;
    }
#else
    z_stream zs{};
    zs.next_in = const_cast<Bytef*>(p + 12 + xlen);
    zs.avail_in = bsize - 12 - xlen - 8;
    zs.next_out = out->data();
    zs.avail_out = isize;
    if (inflateInit2(&zs, -15) != Z_OK) {
      *err = "inflateInit2 failed";
      return false;
    }
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END || zs.total_out != isize) {
      *err = "BGZF inflate failed";
      return false;
    }
#endif
  }
  return true;
}

constexpr size_t kRaDepth = 256;  // prefetched blocks in flight (~16 MB raw)

// Queue undecoded blocks ahead of `from` until kRaDepth are in flight.
// Header scanning (block_bsize) is trivial next to inflate; a block whose
// header fails to parse stays unscheduled and surfaces its precise error
// when the cursor reaches it.
void ra_schedule(Reader* r, size_t from) {
  std::string err;
  bool added = false;
  {
    std::lock_guard<std::mutex> lk(r->ra_mu);
    if (r->ra_next < from) r->ra_next = from;
    // stale entries (left behind by seeks) are bounded by the depth cap
    if (r->ra_cache.size() > 4 * kRaDepth) r->ra_cache.clear();
    size_t ahead = r->ra_cache.size() + r->ra_pending.size();
    while (ahead < kRaDepth && r->ra_next < r->size) {
      size_t c = r->ra_next;
      uint32_t bs;
      auto it = r->ra_cache.find(c);
      if (it != r->ra_cache.end()) {
        bs = it->second.csize;
      } else {
        bs = block_bsize(r, c, &err);
        if (bs == 0) break;
        if (!r->ra_pending.count(c)) {
          r->ra_pending.insert(c);
          r->ra_todo.push_back({c, bs});
          ++ahead;
          added = true;
        }
      }
      r->ra_next = c + bs;
    }
  }
  if (added) r->ra_work_cv.notify_all();
}

void ra_worker(Reader* r) {
  ThreadRole role(r->ctr, kReadahead);
  for (;;) {
    std::pair<size_t, uint32_t> job;
    {
      std::unique_lock<std::mutex> lk(r->ra_mu);
      r->ra_work_cv.wait(
          lk, [&] { return !r->ra_todo.empty() || r->ra_closing; });
      if (r->ra_closing) return;
      job = r->ra_todo.front();
      r->ra_todo.pop_front();
    }
    DecodedBlock db;
    db.csize = job.second;
    std::string e;
    if (!inflate_block(r, job.first, job.second, &db.data, &e))
      db.csize = 0;  // marker: leave uncached; consumer decodes inline
    {
      std::lock_guard<std::mutex> lk(r->ra_mu);
      r->ra_pending.erase(job.first);
      if (db.csize) r->ra_cache.emplace(job.first, std::move(db));
    }
    r->ra_done_cv.notify_all();
  }
}

// Inflate one BGZF block at coffset; returns false on error.
bool load_block(Reader* r, size_t coffset) {
  if (coffset == r->block_coffset) return true;
  if (!r->ra_pool.empty()) {
    bool taken = false;
    {
      std::unique_lock<std::mutex> lk(r->ra_mu);
      for (;;) {
        auto it = r->ra_cache.find(coffset);
        if (it != r->ra_cache.end()) {
          r->block = std::move(it->second.data);
          r->block_csize = it->second.csize;
          r->block_coffset = coffset;
          r->ra_cache.erase(it);
          taken = true;
          break;
        }
        if (!r->ra_pending.count(coffset)) break;  // decode failed or seek
        wd_wait(r->ra_done_cv, lk, "load_block ra",
                [&] {
                  return r->ra_cache.count(coffset) ||
                         !r->ra_pending.count(coffset);
                },
                [&] {
                  char b[120];
                  snprintf(b, sizeof b,
                           "coffset=%zu todo=%zu pending=%zu cache=%zu",
                           coffset, r->ra_todo.size(), r->ra_pending.size(),
                           r->ra_cache.size());
                  return std::string(b);
                });
      }
    }
    if (taken) {
      ra_schedule(r, coffset + r->block_csize);
      return true;
    }
    // cold start / post-seek miss: decode inline, then prime the pipeline
  }
  uint32_t bsize = block_bsize(r, coffset, &r->error);
  if (bsize == 0) return false;
  if (!inflate_block(r, coffset, bsize, &r->block, &r->error)) return false;
  r->block_coffset = coffset;
  r->block_csize = bsize;
  if (!r->ra_pool.empty()) ra_schedule(r, coffset + bsize);
  return true;
}

// Push-mode drain: block until data, EOF, or close.  A close mid-stream
// surfaces as a short read, which the BAM framing loop upgrades to a
// "truncated record" error unless it lands exactly on a record boundary —
// the Python side therefore re-raises the producer's own exception after
// the scan to avoid any silent-truncation window.
size_t push_read(Reader* r, uint8_t* out, size_t n) {
  size_t got = 0;
  std::unique_lock<std::mutex> lk(r->push_mu);
  while (n > 0) {
    wd_wait(r->push_cv_data, lk, "push_read data",
            [&] {
              return !r->push_q.empty() || r->push_eof || r->push_closed;
            },
            [&] {
              char b[120];
              snprintf(b, sizeof b, "buffered=%zu eof=%d closed=%d",
                       r->push_buffered, (int)r->push_eof,
                       (int)r->push_closed);
              return std::string(b);
            });
    if (r->push_q.empty()) break;
    std::vector<uint8_t>& front = r->push_q.front();
    size_t take = front.size() - r->push_front_off;
    if (take > n) take = n;
    std::memcpy(out + got, front.data() + r->push_front_off, take);
    r->push_front_off += take;
    got += take;
    n -= take;
    if (r->push_front_off == front.size()) {
      r->push_buffered -= front.size();
      r->push_q.pop_front();
      r->push_front_off = 0;
      r->push_cv_space.notify_all();
    }
  }
  return got;
}

// Read exactly n bytes from the cursor; returns bytes read (short at EOF).
size_t reader_read(Reader* r, uint8_t* out, size_t n) {
  if (r->push_mode) return push_read(r, out, n);
  size_t got = 0;
  while (n > 0) {
    if (r->coffset >= r->size) break;
    if (!load_block(r, r->coffset)) break;
    if (r->uoffset >= r->block.size()) {
      r->coffset += r->block_csize;
      r->uoffset = 0;
      continue;
    }
    size_t take = r->block.size() - r->uoffset;
    if (take > n) take = n;
    std::memcpy(out + got, r->block.data() + r->uoffset, take);
    r->uoffset += static_cast<uint32_t>(take);
    got += take;
    n -= take;
  }
  return got;
}

// ---------------------------------------------------------------------------
// Writer with pool-threaded block compression.
// ---------------------------------------------------------------------------

struct Job {
  std::vector<uint8_t> raw;        // uncompressed payload (<= 0xff00)
  std::vector<uint8_t> out;        // finished BGZF block
  bool done = false;
};

struct Writer {
  FILE* f = nullptr;
  int level = 6;
  int n_threads = 1;
  size_t max_inflight = 64;  // blocks (~64 KB raw each) queued to the pool
  std::vector<std::thread> pool;
  bgzf::Card* card = nullptr;  // deflates on the card, in place of the pool
  std::thread codec;           // the card's staging thread
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<Job*> todo;
  std::deque<Job*> inflight;       // in write order
  bool closing = false;
  bool io_closing = false;
  std::condition_variable cv_space;
  std::thread io;                  // ordered fwrite drain (pooled mode)
  std::vector<uint8_t> pending;    // uncompressed tail < block size
  std::string error;
  Counters* ctr = nullptr;  // set before the pool starts
};

// Persistent per-caller deflate state: deflateInit2 allocates + clears
// ~270 KB of window/hash state, which is real CPU when paid per 64 KB
// block; the context reuses it (deflateReset / persistent libdeflate
// compressor).
struct DeflateCtx {
#ifdef PTIO_HAVE_LIBDEFLATE
  libdeflate_compressor* c = nullptr;
  ~DeflateCtx() {
    if (c) libdeflate_free_compressor(c);
  }
#else
  z_stream zs{};
  bool init = false;
#endif
  int level = -1;
  std::vector<uint8_t> cdata;
};

// A BGZF block around a raw deflate stream of a payload of isize bytes.
void frame_block(const uint8_t* cdata, size_t clen, uint32_t crc,
                 uint32_t isize, std::vector<uint8_t>* out) {
  uint32_t bsize = static_cast<uint32_t>(clen) + 26;
  out->resize(18 + clen + 8);
  uint8_t* p = out->data();
  const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0};
  std::memcpy(p, hdr, 12);
  p[12] = 'B';
  p[13] = 'C';
  p[14] = 2;
  p[15] = 0;
  uint16_t bs16 = static_cast<uint16_t>(bsize - 1);
  std::memcpy(p + 16, &bs16, 2);
  std::memcpy(p + 18, cdata, clen);
  std::memcpy(p + 18 + clen, &crc, 4);
  std::memcpy(p + 18 + clen + 4, &isize, 4);
}

void compress_block_ctx(DeflateCtx* ctx, int level,
                        const std::vector<uint8_t>& raw,
                        std::vector<uint8_t>* out) {
  size_t clen;
  uint32_t crc;
#ifdef PTIO_HAVE_LIBDEFLATE
  if (!ctx->c || ctx->level != level) {
    // one caller thread may feed writers at different levels (e.g. the
    // level-0 stdout writer + a level-6 file writer)
    if (ctx->c) libdeflate_free_compressor(ctx->c);
    ctx->c = libdeflate_alloc_compressor(level);
    ctx->level = level;
  }
  size_t bound = libdeflate_deflate_compress_bound(ctx->c, raw.size());
  if (ctx->cdata.size() < bound) ctx->cdata.resize(bound);
  clen = libdeflate_deflate_compress(ctx->c, raw.data(), raw.size(),
                                     ctx->cdata.data(), ctx->cdata.size());
  crc = libdeflate_crc32(0, raw.data(), raw.size());
#else
  uLong bound = compressBound(raw.size()) + 64;
  if (ctx->init && ctx->level != level) {
    deflateEnd(&ctx->zs);
    ctx->init = false;
  }
  if (!ctx->init) {
    deflateInit2(&ctx->zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
    ctx->init = true;
    ctx->level = level;
  } else {
    deflateReset(&ctx->zs);
  }
  if (ctx->cdata.size() < bound) ctx->cdata.resize(bound);
  z_stream& zs = ctx->zs;
  zs.next_in = const_cast<Bytef*>(raw.data());
  zs.avail_in = raw.size();
  zs.next_out = ctx->cdata.data();
  zs.avail_out = ctx->cdata.size();
  deflate(&zs, Z_FINISH);
  clen = zs.total_out;
  crc = crc32(0, raw.data(), raw.size());
#endif
  frame_block(ctx->cdata.data(), clen, crc, raw.size(), out);
}

void worker_main(Writer* w) {
  ThreadRole role(w->ctr, kDeflate);
  for (;;) {
    Job* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_work.wait(lk, [&] { return !w->todo.empty() || w->closing; });
      if (w->todo.empty()) return;
      job = w->todo.front();
      w->todo.pop_front();
    }
    static thread_local DeflateCtx ctx;
    compress_block_ctx(&ctx, w->level, job->raw, &job->out);
    if (w->ctr) ++w->ctr->deflate_host;
    {
      std::lock_guard<std::mutex> lk(w->mu);
      job->done = true;
    }
    w->cv_done.notify_all();
  }
}

void card_check(Writer* w, int rc) {
  if (!rc) return;
  std::lock_guard<std::mutex> lk(w->mu);
  if (w->error.empty())
    w->error = "card deflate failed: CUDA error " + std::to_string(rc);
}

// Waits for a staged set whose submit succeeded (`submitted`), frames its
// streams as BGZF blocks and hands the jobs to the io thread.  A set that
// failed on the card goes to the io thread unframed: the writer's error is
// set, and its close reports it.  Returns whether the set was framed.
bool card_finish(Writer* w, int s, std::vector<Job*>* jobs, bool submitted) {
  bgzf::Card* card = w->card;
  bool ok = submitted;
  if (ok) {
    long long t0 = now_ns();
    int rc = card->wait(card, s);
    if (w->ctr) w->ctr->add_wait("card_deflate done", kDeflate, now_ns() - t0);
    card_check(w, rc);
    ok = !rc;
  }
  const bgzf::CardSet& st = card->set[s];
  if (ok)
    for (size_t k = 0; k < jobs->size(); ++k)
      frame_block(st.out + k * bgzf::kOutStride, st.out_len[k], st.crc[k],
                  (*jobs)[k]->raw.size(), &(*jobs)[k]->out);
  if (w->ctr && ok) w->ctr->deflate_card += jobs->size();
  {
    std::lock_guard<std::mutex> lk(w->mu);
    for (Job* job : *jobs) job->done = true;
  }
  w->cv_done.notify_all();
  jobs->clear();
  return ok;
}

// The card's codec: one thread in place of the deflate pool.  It stages up
// to max_blocks queued payloads in one pinned set while the other set is on
// the card, then waits for the older set and frames it; the io thread
// writes the blocks in order, as it does the pool's.  After the first
// failed submit or wait it sends nothing more to the card.
void card_main(Writer* w) {
  ThreadRole role(w->ctr, kDeflate);
  bgzf::Card* card = w->card;
  std::vector<Job*> staged[2];
  bool submitted[2] = {false, false};
  int fill = 0;          // the set staged next
  bool on_card = false;  // the other set is on the card
  bool failed = false;   // a submit or a wait failed
  for (;;) {
    std::vector<Job*>& next = staged[fill];
    {
      std::unique_lock<std::mutex> lk(w->mu);
      if (!on_card)
        w->cv_work.wait(lk, [&] { return !w->todo.empty() || w->closing; });
      size_t k = std::min(w->todo.size(), (size_t)card->max_blocks);
      next.assign(w->todo.begin(), w->todo.begin() + k);
      w->todo.erase(w->todo.begin(), w->todo.begin() + k);
    }
    if (next.empty() && !on_card) return;
    submitted[fill] = false;
    if (!next.empty() && !failed) {
      const bgzf::CardSet& st = card->set[fill];
      for (size_t k = 0; k < next.size(); ++k) {
        std::memcpy(st.in + k * bgzf::kMaxPayload, next[k]->raw.data(),
                    next[k]->raw.size());
        st.in_len[k] = static_cast<int32_t>(next[k]->raw.size());
      }
      int rc = card->submit(card, fill, static_cast<int>(next.size()));
      card_check(w, rc);
      submitted[fill] = !rc;
      failed = rc != 0;
      if (w->ctr && !rc) ++w->ctr->deflate_launches;
    }
    if (on_card &&
        !card_finish(w, fill ^ 1, &staged[fill ^ 1], submitted[fill ^ 1]))
      failed = true;
    on_card = !next.empty();
    if (on_card) fill ^= 1;
  }
}

// Drain finished jobs at the front of the in-flight queue to the file.
// Dedicated IO thread: drains finished jobs in write order and fwrites
// them, so the submitting thread (the scanner's finisher) never pays for
// file writes or completed-prefix bookkeeping — only honest backpressure
// when the deflate pool is the true bottleneck (the inflight cap).
void io_main(Writer* w) {
  ThreadRole role(w->ctr, kWriterIo);
  for (;;) {
    Job* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_done.wait(lk, [&] {
        return (!w->inflight.empty() && w->inflight.front()->done) ||
               (w->io_closing && w->inflight.empty());
      });
      if (w->inflight.empty()) return;
      job = w->inflight.front();
      w->inflight.pop_front();
    }
    if (fwrite(job->out.data(), 1, job->out.size(), w->f) !=
        job->out.size()) {
      std::lock_guard<std::mutex> lk(w->mu);
      if (w->error.empty()) w->error = "write failed";
    }
    delete job;
    w->cv_space.notify_all();
  }
}

void writer_submit(Writer* w, std::vector<uint8_t>&& raw) {
  Job* job = new Job();
  job->raw = std::move(raw);
  if (w->n_threads <= 1 && !w->card) {
    static thread_local DeflateCtx ctx;
    compress_block_ctx(&ctx, w->level, job->raw, &job->out);
    if (w->ctr) ++w->ctr->deflate_host;
    if (fwrite(job->out.data(), 1, job->out.size(), w->f) != job->out.size())
      w->error = "write failed";
    delete job;
    return;
  }
  {
    // Bound memory BEFORE enqueueing: at most max_inflight blocks
    // (~64 KB raw each) queued to the pool + IO thread.
    std::unique_lock<std::mutex> lk(w->mu);
    wd_wait(w->cv_space, lk, "writer_submit space",
            [&] { return w->inflight.size() < w->max_inflight; },
            [&] {
              char b[160];
              snprintf(b, sizeof b,
                       "inflight=%zu todo=%zu front_done=%d closing=%d "
                       "err='%s'",
                       w->inflight.size(), w->todo.size(),
                       w->inflight.empty() ? -1
                                           : (int)w->inflight.front()->done,
                       (int)w->closing, w->error.c_str());
              return std::string(b);
            });
    w->todo.push_back(job);
    w->inflight.push_back(job);
  }
  w->cv_work.notify_one();
}

// A BGZF writer on `path` ("-" for stdout) whose pool threads count into
// `ctr` (null: none).  With a `card` (null: none) a compressing writer
// deflates on the card through one codec thread in place of its pool.
Writer* writer_open(const char* path, int level, int n_threads,
                    Counters* ctr, bgzf::Card* card) {
  Writer* w = new Writer();
  w->f = (std::strcmp(path, "-") == 0) ? stdout : fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->level = level;
  w->n_threads = n_threads < 1 ? 1 : n_threads;
  w->ctr = ctr;
  // deep enough that encode bursts never stall on a momentarily-busy pool
  // (~16 MB raw at 256: deflate is the dominant host cost and the producer
  // must be able to run ahead through device-compute windows)
  w->max_inflight = std::max<size_t>(256, 32 * w->n_threads);
  if (card && level > 0) {
    w->card = card;
    w->codec = std::thread(card_main, w);
    w->io = std::thread(io_main, w);
  } else if (w->n_threads > 1) {
    for (int i = 0; i < w->n_threads; ++i)
      w->pool.emplace_back(worker_main, w);
    w->io = std::thread(io_main, w);
  }
  return w;
}

// Each position's nearest earlier position of its trigram's hash (kNil:
// none), the chains that find_match walks.
std::vector<uint16_t> hash_chains(const uint8_t* in, int n) {
  using namespace bgzf;
  std::vector<uint16_t> prev(n + 1, kNil);
  std::vector<uint16_t> head(1u << kHashBits, kNil);
  for (int i = 0; i + 2 < n; ++i) {
    uint32_t h = hash3(in, i);
    prev[i] = head[h];
    head[h] = static_cast<uint16_t>(i);
  }
  return prev;
}

// bgzf_deflate.h's algorithm on the host, step by step as the card runs
// it: the deflate stream of in[0..n), n <= 65280, into out (65536 bytes);
// returns its bytes and sets *crc.
int bgzf_deflate_plain(const uint8_t* in, int n, uint8_t* out,
                       uint32_t* crc) {
  using namespace bgzf;
  std::vector<uint16_t> prev = hash_chains(in, n), desc(n + 1);
  std::vector<uint32_t> match(n + 1);
  for (int i = 0; i < n; ++i) {
    match[i] = find_match(in, n, prev.data(), i);
    desc[i] = static_cast<uint16_t>(match[i] >> 16);
  }
  lazy_parse(desc.data(), n);
  for (int p = 0; p < n; ++p)
    if (is_match_start(desc[p])) desc[p + 1] = match[p] & 0xffff;
  uint32_t table[256];
  for (uint32_t k = 0; k < 256; ++k) table[k] = crc_table_entry(k);
  *crc = 0;  // the CRCs of 128-byte pieces, combined as the kernel does
  for (int off = 0; off < n; off += 128) {
    int len = std::min(128, n - off);
    *crc = crc32_combine(*crc, crc32_bytes(table, in + off, len), len);
  }
  // the kernel's chunks of positions, one after another
  constexpr int kChunk = 128, kChunks = (kMaxPayload + kChunk - 1) / kChunk;
  std::vector<uint32_t> sym(kChunks + 1), bits(kChunks + 1);
  for (int t = 0; t < kChunks; ++t)
    sym[t + 1] = sym[t] + chunk_symbols(desc.data(), n, t, kChunk);
  auto plan = std::make_unique<Plan>();
  plan_clear(plan.get(), sym[kChunks], n, 0, 1);
  for (int t = 0; t < kChunks; ++t)
    chunk_count(in, desc.data(), n, t, kChunk, sym[t], plan.get());
  for (int k = 0; k < plan->n_blocks; ++k) plan_block(plan.get(), k);
  plan_offsets(plan.get());
  for (int t = 0; t < kChunks; ++t)
    bits[t + 1] = bits[t] + chunk_bits(in, desc.data(), n, t, kChunk, sym[t],
                                       plan.get());
  std::vector<unsigned long long> words(kOutStride / 8 + 1);
  for (int t = 0; t < kChunks; ++t)
    chunk_write(in, desc.data(), n, t, kChunk, sym[t], bits[t], plan.get(),
                words.data());
  write_headers(plan.get(), words.data());
  write_stored(in, plan.get(), 0, 1, words.data());
  int nbytes = (plan->total_bits + 7) / 8;
  std::memcpy(out, words.data(), nbytes);
  return nbytes;
}

// A card that deflates on the host with bgzf_deflate_plain, so that the
// tests drive a writer's codec thread without one.  It counts its submits
// and waits, and its submit number `fail_at` (from 0; -1: none) fails.
struct HostCard {
  bgzf::Card card{};
  std::vector<uint8_t> in[2], out[2];
  std::vector<int32_t> in_len[2], out_len[2];
  std::vector<uint32_t> crc[2];
  int fail_at = -1;
  int submits = 0, waits = 0;
};

int host_card_submit(bgzf::Card* card, int s, int n) {
  HostCard* h = reinterpret_cast<HostCard*>(card);
  if (h->submits++ == h->fail_at) return 1;
  const bgzf::CardSet& st = card->set[s];
  for (int k = 0; k < n; ++k)
    st.out_len[k] = bgzf_deflate_plain(st.in + k * bgzf::kMaxPayload,
                                       st.in_len[k],
                                       st.out + k * bgzf::kOutStride,
                                       &st.crc[k]);
  return 0;
}

int host_card_wait(bgzf::Card* card, int) {
  ++reinterpret_cast<HostCard*>(card)->waits;
  return 0;
}

}  // namespace

extern "C" {

// --- the card's compressor on the host (tests only) -----------------------

int ptio_bgzf_deflate_plain(const uint8_t* in, int n, uint8_t* out,
                            uint32_t* crc) {
  return bgzf_deflate_plain(in, n, out, crc);
}

void* ptio_bgzf_host_card(int max_blocks) {
  HostCard* h = new HostCard();
  h->card.submit = host_card_submit;
  h->card.wait = host_card_wait;
  h->card.max_blocks = max_blocks;
  for (int s = 0; s < 2; ++s) {
    h->in[s].resize((size_t)max_blocks * bgzf::kMaxPayload);
    h->out[s].resize((size_t)max_blocks * bgzf::kOutStride);
    h->in_len[s].resize(max_blocks);
    h->out_len[s].resize(max_blocks);
    h->crc[s].resize(max_blocks);
    h->card.set[s] = {h->in[s].data(), h->in_len[s].data(), h->out[s].data(),
                      h->out_len[s].data(), h->crc[s].data()};
  }
  return &h->card;  // the first member: the HostCard's own address
}

void ptio_bgzf_host_card_free(void* card) {
  delete reinterpret_cast<HostCard*>(card);
}

// The chain entries that the match search looks at over in[0..n), n <=
// 65280: the work that bounds the kernel (chip_smoke.py).
long long ptio_bgzf_search_visits(const uint8_t* in, int n) {
  std::vector<uint16_t> prev = hash_chains(in, n);
  long long visits = 0;
  for (int i = 0; i < n; ++i) bgzf::find_match(in, n, prev.data(), i, &visits);
  return visits;
}

// Makes the host card's submit number `fail_at` fail.
void ptio_bgzf_host_card_fail(void* card, int fail_at) {
  reinterpret_cast<HostCard*>(card)->fail_at = fail_at;
}

// The host card's submits so far; *waits gets its waits.
int ptio_bgzf_host_card_calls(void* card, int* waits) {
  HostCard* h = reinterpret_cast<HostCard*>(card);
  *waits = h->waits;
  return h->submits;
}

// A writer that deflates through `card` (a bgzf::Card).
void* ptio_writer_open_card(const char* path, int level, int n_threads,
                            void* card) {
  return writer_open(path, level, n_threads, nullptr,
                     static_cast<bgzf::Card*>(card));
}

// --- reader ---------------------------------------------------------------

void* ptio_reader_open(const char* path) {
  Reader* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->size = st.st_size;
  if (r->size > 0) {
    r->data = static_cast<const uint8_t*>(
        mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0));
    if (r->data == MAP_FAILED) {
      close(r->fd);
      delete r;
      return nullptr;
    }
  }
  return r;
}

void ptio_reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (!r->ra_pool.empty()) {
    {
      std::lock_guard<std::mutex> lk(r->ra_mu);
      r->ra_closing = true;
    }
    r->ra_work_cv.notify_all();
    for (auto& t : r->ra_pool) t.join();
  }
  if (r->data && r->size) munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

long long ptio_read(void* h, uint8_t* out, long long n) {
  return reader_read(static_cast<Reader*>(h), out, n);
}

// Open a push-mode reader: bytes arrive via ptio_reader_push instead of a
// file.  cap_bytes bounds producer run-ahead (<=0 keeps the 64 MB default).
void* ptio_reader_open_push(long long cap_bytes) {
  Reader* r = new Reader();
  r->push_mode = true;
  if (cap_bytes > 0) r->push_cap = static_cast<size_t>(cap_bytes);
  return r;
}

// Blocking bounded push; returns 0, or -1 once the stream is closed.
int ptio_reader_push(void* h, const uint8_t* data, long long n) {
  Reader* r = static_cast<Reader*>(h);
  if (!r->push_mode || n < 0) return -1;
  std::unique_lock<std::mutex> lk(r->push_mu);
  wd_wait(r->push_cv_space, lk, "push space",
          [&] { return r->push_buffered < r->push_cap || r->push_closed; },
          [&] {
            char b[96];
            snprintf(b, sizeof b, "buffered=%zu cap=%zu eof=%d",
                     r->push_buffered, r->push_cap, (int)r->push_eof);
            return std::string(b);
          });
  if (r->push_closed || r->push_eof) return -1;
  r->push_q.emplace_back(data, data + n);
  r->push_buffered += static_cast<size_t>(n);
  lk.unlock();
  r->push_cv_data.notify_all();
  return 0;
}

void ptio_reader_push_eof(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->push_mu);
    r->push_eof = true;
  }
  r->push_cv_data.notify_all();
}

// Abort the stream from either side: wakes a blocked producer (push
// returns -1) and makes the consumer see EOF at the current point.
void ptio_reader_push_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->push_mu);
    r->push_closed = true;
    r->push_q.clear();
    r->push_buffered = 0;
    r->push_front_off = 0;
  }
  r->push_cv_data.notify_all();
  r->push_cv_space.notify_all();
}

// Enable parallel BGZF readahead decode with n worker threads (1 = serial).
void ptio_reader_set_threads(void* h, int n) {
  Reader* r = static_cast<Reader*>(h);
  if (r->push_mode) return;  // no BGZF to inflate ahead
  r->n_threads = n < 1 ? 1 : n;
  if (r->n_threads > 1 && r->ra_pool.empty()) {
    for (int i = 0; i < r->n_threads; ++i)
      r->ra_pool.emplace_back(ra_worker, r);
  }
}

void ptio_seek_voffset(void* h, unsigned long long voffset) {
  Reader* r = static_cast<Reader*>(h);
  r->coffset = voffset >> 16;
  r->uoffset = voffset & 0xffff;
}

unsigned long long ptio_tell_voffset(void* h) {
  Reader* r = static_cast<Reader*>(h);
  // htslib normalizes an exhausted block to (next_block << 16 | 0):
  // without this, a spec-max 65536-byte block would overflow the uoffset
  // bits into coffset, and voffsets recorded at exact block boundaries
  // (index chunk ends) would disagree with htslib-built indexes.
  if (r->coffset == r->block_coffset && !r->block.empty() &&
      r->uoffset >= r->block.size())
    return static_cast<unsigned long long>(r->coffset + r->block_csize) << 16;
  return (static_cast<unsigned long long>(r->coffset) << 16) | r->uoffset;
}

// Bulk record scan: fill out_buf with consecutive size-prefixed BAM records
// ([i32 size][payload])...  Stops when the buffer is full, max_records is
// reached, the virtual offset reaches limit_voffset (0 = none), or EOF.
// Returns the number of records; *n_bytes gets the bytes written.
long long ptio_read_records(void* h, uint8_t* out_buf, long long buf_cap,
                            long long max_records,
                            unsigned long long limit_voffset,
                            long long* n_bytes) {
  Reader* r = static_cast<Reader*>(h);
  long long count = 0;
  long long used = 0;
  while (count < max_records) {
    unsigned long long v = ptio_tell_voffset(h);
    if (limit_voffset && v >= limit_voffset) break;
    uint8_t szb[4];
    // Peek: save position to rewind if the record doesn't fit.
    size_t save_co = r->coffset;
    uint32_t save_uo = r->uoffset;
    if (reader_read(r, szb, 4) < 4) break;
    int32_t bsz;
    std::memcpy(&bsz, szb, 4);
    if (bsz < 32) {
      // corrupt size field: rewinding and returning 0 would read as a clean
      // EOF upstream, silently dropping the rest of the file
      r->coffset = save_co;
      r->uoffset = save_uo;
      return -1;
    }
    if (used + 4 + bsz > buf_cap) {
      r->coffset = save_co;
      r->uoffset = save_uo;
      if (count == 0) {
        // first record exceeds the caller's buffer: report the required
        // capacity so the caller can grow and retry (never a silent stop)
        *n_bytes = 4 + (long long)bsz;
        return -2;
      }
      break;
    }
    std::memcpy(out_buf + used, szb, 4);
    if (reader_read(r, out_buf + used + 4, bsz) < static_cast<size_t>(bsz)) {
      r->coffset = save_co;
      r->uoffset = save_uo;
      break;
    }
    used += 4 + bsz;
    ++count;
  }
  *n_bytes = used;
  return count;
}

int ptio_check_eof(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  if (sz < 28) {
    fclose(f);
    return 0;
  }
  uint8_t buf[28];
  fseek(f, sz - 28, SEEK_SET);
  size_t got = fread(buf, 1, 28, f);
  fclose(f);
  return got == 28 && std::memcmp(buf, kEofMarker, 28) == 0;
}

// --- writer ---------------------------------------------------------------

void* ptio_writer_open(const char* path, int level, int n_threads) {
  return writer_open(path, level, n_threads, nullptr, nullptr);
}

void ptio_write(void* h, const uint8_t* data, long long n) {
  // Single-copy carve: full blocks go straight from the caller's buffer
  // into job storage (the old append + front-erase + block-copy walked
  // every output byte three times); only the <1-block tail is buffered.
  Writer* w = static_cast<Writer*>(h);
  constexpr size_t kBlock = 0xff00;
  size_t off = 0;
  if (!w->pending.empty()) {
    size_t take = std::min<size_t>(kBlock - w->pending.size(), (size_t)n);
    w->pending.insert(w->pending.end(), data, data + take);
    off = take;
    if (w->pending.size() == kBlock) {
      writer_submit(w, std::move(w->pending));
      w->pending.clear();
    }
  }
  while ((size_t)n - off >= kBlock) {
    writer_submit(w, std::vector<uint8_t>(data + off, data + off + kBlock));
    off += kBlock;
  }
  w->pending.insert(w->pending.end(), data + off, data + n);
}

int ptio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  if (!w->pending.empty()) {
    writer_submit(w, std::move(w->pending));
    w->pending.clear();
  }
  if (w->io.joinable()) {
    {
      std::lock_guard<std::mutex> lk(w->mu);
      w->closing = true;
    }
    w->cv_work.notify_all();
    for (auto& t : w->pool) t.join();
    if (w->codec.joinable()) w->codec.join();
    {
      std::lock_guard<std::mutex> lk(w->mu);
      w->io_closing = true;
    }
    w->cv_done.notify_all();
    w->io.join();
  }
  fwrite(kEofMarker, 1, 28, w->f);
  fflush(w->f);
  int ok = w->error.empty() ? 1 : 0;
  if (w->f != stdout) fclose(w->f);
  delete w;
  return ok;
}

}  // extern "C"
