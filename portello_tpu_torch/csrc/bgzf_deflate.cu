// BGZF block deflate on the card: a batch of raw BGZF payloads (at most
// 65,280 bytes each) into raw deflate streams, with each payload's CRC32 and
// compressed length.
//
// Replaces no TPU kernel: the JAX package, like the port's host path,
// deflates its output BAMs with zlib on the host.  Without libdeflate, zlib
// level 6 deflates about 20 MB/s a core, most of a call's CPU on an 8-core
// host, while the card sits idle; every BGZF block is an independent
// deflate stream, so a call's ~9,000 blocks are parallel work.  The output
// is at least as small as zlib level 6's (bgzf_deflate.h says what the
// algorithm is); the same header, built with g++, is the plain version in
// io/native/ptio.cc, and the two give the same bytes.
//
// What bounds it: the match search.  A BAM's quality strings are
// low-entropy (most bytes one value), so a trigram's chain is long and most
// positions look at their whole budget of 128 candidates, each a load of
// its trigram and, where it could be longer, a compare of a few bytes.
// Bytes moved are negligible (64 KB in, about 16 KB out a block).
//
// Design: one block of 1,024 threads per BGZF block (a grid-stride loop when
// the grid is smaller than the batch), the payload in shared memory.
//   1. The positions are sorted by a 13-bit hash of their trigram (counting
//      sort: histogram with shared atomics, a block scan, then one warp
//      scatters them in position order with __match_any_sync, so each
//      bucket lists its positions ascending).  Meanwhile the other warps
//      compute the CRC32 of their spans and combine them.
//   2. The search runs a thread per position, in bucket order, so a warp's
//      positions share a bucket and walk lists of about the same length: a
//      position's chain is the entries before it in its bucket, nearest
//      first, and the next is loaded while one is compared; most are
//      passed over on the one byte that a longer match must equal.
//      Results go to the global scratch (4 bytes a position).
//   3. Thread 0 runs the lazy parse over the lengths (in shared memory, over
//      the sorted list's space); the block writes each match's distance
//      beside it, and then the stream a chunk of positions a thread
//      (bgzf_deflate.h): scans number the symbols and place their bits, the
//      first warps build a deflate block's trees each, and the bits go into
//      the output with atomic ORs.
// The C entry launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().  ptt_bgzf_card_create allocates, once per
// writer and process, the staging that ptio.cc's codec thread uses, with
// its own non-blocking stream.

#include <cuda_runtime.h>

#include <cstdint>

#include "bgzf_deflate.h"

using namespace bgzf;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 1 << kHashBits;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: the payload (zero-padded for word loads), the sorted
// positions (later the parse), the buckets (later the trees' scratch), the
// CRC table and the warps' CRC spans.
constexpr int kDataBytes = kMaxPayload + 32;
constexpr int kSortedOff = kDataBytes;
constexpr int kBucketsOff = kSortedOff + kMaxPayload * 2;
constexpr int kCrcTableOff = kBucketsOff + kBuckets * 4;
constexpr int kCrcPartOff = kCrcTableOff + 256 * 4;
constexpr int kScanOff = kCrcPartOff + kWarps * 8;
constexpr int kSmemBytes = kScanOff + kWarps * 4;
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert(sizeof(Plan) <= kBuckets * 4, "the plan fits the buckets");
constexpr int kChunk = (kMaxPayload + kThreads - 1) / kThreads;  // a thread's
static_assert(kDataBytes % 16 == 0 && kSortedOff % 16 == 0, "alignment");

// The CRC spans: a span a thread of the warps but the first.
constexpr int kCrcThreads = kThreads - 32;
constexpr int kCrcSpan = (kMaxPayload + kCrcThreads - 1) / kCrcThreads;
static_assert(kWarps - 1 <= 32, "a warp combines the warps' CRCs");


// Four bytes at any offset of a 4-aligned shared buffer.
__device__ __forceinline__ uint32_t load_word(const uint8_t* d, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(d) + (p >> 2);
  return __funnelshift_r(w[0], w[1], (p & 3) * 8);
}

__device__ __forceinline__ int prefix_words(const uint8_t* d, int c, int i,
                                            int maxlen) {
  for (int k = 0; k < maxlen; k += 4) {
    uint32_t x = load_word(d, c + k) ^ load_word(d, i + k);
    if (x) {
      int len = k + ((__ffs(x) - 1) >> 3);
      return len < maxlen ? len : maxlen;
    }
  }
  return maxlen;
}

// find_match of bgzf_deflate.h for position i = sorted[r], whose bucket
// begins at sorted[start]: the bucket's earlier entries, nearest first, are
// i's chain.  The next entry is loaded while one is compared.
__device__ uint32_t lane_find_match(const uint8_t* d, int n,
                                    const uint16_t* sorted, int r, int start) {
  int i = sorted[r];
  int maxlen = n - i < kMaxMatch ? n - i : kMaxMatch;
  int best = 2, best_dist = 0;
  uint8_t after = d[i + best];  // the byte that a longer match must equal
  int last = r - kMaxChain > start ? r - kMaxChain : start;
  int c = r - 1 >= last ? sorted[r - 1] : -1;
  for (int j = r - 1; j >= last && i - c <= kWindow; --j) {
    int c_next = j - 1 >= last ? sorted[j - 1] : 0;
    if (d[c + best] == after) {
      int len = prefix_words(d, c, i, maxlen);
      if (len > best) {
        best = len;
        best_dist = i - c;
        if (best == maxlen) break;
        after = d[i + best];
      }
    }
    c = c_next;
  }
  if (best < 3 || (best == 3 && best_dist > kTooFar)) return 0;
  return (uint32_t)best << 16 | (uint32_t)(best_dist - 1);
}

// An exclusive scan of one value a thread over the block; *total gets the
// sum.  warp_sums holds kWarps entries.
__device__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums, uint32_t* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
  for (int s = 1; s < 32; s <<= 1) {
    uint32_t x = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  uint32_t base = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    uint32_t x = warp_sums[w];
    base += w < warp ? x : 0;
    sum += x;
  }
  *total = sum;
  __syncthreads();
  return base + incl - v;
}

// The CRC32 of a warp's spans (each thread's crc and len), in lane 0.
__device__ uint32_t warp_crc(uint32_t crc, int len, int lane) {
  for (int s = 1; s < 32; s <<= 1) {
    uint32_t c2 = __shfl_down_sync(kFull, crc, s);
    int l2 = __shfl_down_sync(kFull, len, s);
    if ((lane & (2 * s - 1)) == 0 && lane + s < 32) {
      crc = crc32_combine(crc, c2, (uint32_t)l2);
      len += l2;
    }
  }
  return crc;
}

__global__ void __launch_bounds__(kThreads, 1)
    bgzf_deflate_kernel(const uint8_t* __restrict__ in,
                        const int32_t* __restrict__ in_len, int n_blocks,
                        uint8_t* __restrict__ out, int32_t* __restrict__ out_len,
                        uint32_t* __restrict__ crc_out,
                        uint32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* data = smem;
  uint16_t* sorted = reinterpret_cast<uint16_t*>(smem + kSortedOff);
  uint16_t* desc = sorted;
  uint32_t* buckets = reinterpret_cast<uint32_t*>(smem + kBucketsOff);
  Plan* plan = reinterpret_cast<Plan*>(smem + kBucketsOff);
  uint32_t* crc_table = reinterpret_cast<uint32_t*>(smem + kCrcTableOff);
  uint32_t* crc_part = reinterpret_cast<uint32_t*>(smem + kCrcPartOff);
  uint32_t* warp_sums = reinterpret_cast<uint32_t*>(smem + kScanOff);
  int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t total;

  if (tid < 256) crc_table[tid] = crc_table_entry(tid);
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    int n = in_len[b];
    const uint4* src = reinterpret_cast<const uint4*>(in + (size_t)b * kMaxPayload);
    uint32_t* match = scratch + (size_t)b * kMaxPayload;
    unsigned long long* dst =
        reinterpret_cast<unsigned long long*>(out + (size_t)b * kOutStride);
    for (int k = tid; k < (n + 15) / 16; k += kThreads)
      reinterpret_cast<uint4*>(data)[k] = src[k];
    for (int k = tid; k < kBuckets; k += kThreads) buckets[k] = 0;
    __syncthreads();
    if (tid < 32) data[n + tid] = 0;
    int m = n >= 3 ? n - 2 : 0;  // positions with a trigram
    for (int i = tid; i < m; i += kThreads) atomicAdd(&buckets[hash3(data, i)], 1u);
    __syncthreads();

    // the buckets' starts: 16 a thread, scanned across the block
    {
      constexpr int kPer = kBuckets / kThreads;
      uint32_t local[kPer], sum = 0;
      for (int k = 0; k < kPer; ++k) {
        local[k] = buckets[tid * kPer + k];
        sum += local[k];
      }
      uint32_t run = block_scan(sum, warp_sums, &total);
      for (int k = 0; k < kPer; ++k) {
        buckets[tid * kPer + k] = run;
        run += local[k];
      }
    }
    __syncthreads();

    if (warp == 0) {
      // stable scatter: positions in order, 32 at a time; afterwards
      // buckets[h] is the end of bucket h
      for (int base = 0; base < m; base += 32) {
        int i = base + lane;
        bool valid = i < m;
        uint32_t h = valid ? hash3(data, i) : kBuckets + lane;
        unsigned peers = __match_any_sync(kFull, h);
        uint32_t off = valid ? buckets[h] : 0;
        if (valid) sorted[off + __popc(peers & ((1u << lane) - 1))] = (uint16_t)i;
        __syncwarp();
        if (valid && (peers >> lane) == 1u) buckets[h] = off + __popc(peers);
        __syncwarp();
      }
    } else {
      // the CRC32 of this thread's span, combined across the warp
      int start = (tid - 32) * kCrcSpan;
      int len = n - start;
      len = len < 0 ? 0 : len > kCrcSpan ? kCrcSpan : len;
      uint32_t crc = warp_crc(crc32_bytes(crc_table, data + start, len), len, lane);
      if (lane == 0) {
        crc_part[2 * (warp - 1)] = crc;
        crc_part[2 * (warp - 1) + 1] = (uint32_t)min(n - (warp - 1) * 32 * kCrcSpan, 32 * kCrcSpan);
      }
    }
    __syncthreads();

    // the search: a thread per position, in bucket order
    for (int r = tid; r < m; r += kThreads) {
      uint32_t h = hash3(data, sorted[r]);
      int start = h ? (int)buckets[h - 1] : 0;
      match[sorted[r]] = lane_find_match(data, n, sorted, r, start);
    }
    for (int i = m + tid; i < n; i += kThreads) match[i] = 0;
    __syncthreads();
    if (warp == 1) {
      // the 15 warps' CRCs, in order
      bool has = lane < kWarps - 1;
      int len = has ? max((int)crc_part[2 * lane + 1], 0) : 0;
      uint32_t crc = warp_crc(has ? crc_part[2 * lane] : 0, len, lane);
      if (lane == 0) crc_out[b] = crc;
    }
    for (int i = tid; i < n; i += kThreads) desc[i] = (uint16_t)(match[i] >> 16);
    for (int k = tid; k < kOutStride / 8; k += kThreads) dst[k] = 0;
    __syncthreads();
    if (tid == 0) lazy_parse(desc, n);
    __syncthreads();
    // each match's distance beside its start, in an entry the match covers.
    // A thread may read such an entry while another writes it: both values
    // lack kStart, so neither reads as a start.
    for (int p = tid; p < n; p += kThreads)
      if (is_match_start(desc[p])) desc[p + 1] = (uint16_t)(match[p] & 0xffff);
    __syncthreads();

    // the stream, a chunk a thread (bgzf_deflate.h)
    uint32_t sym = block_scan(chunk_symbols(desc, n, tid, kChunk), warp_sums, &total);
    plan_clear(plan, total, n, tid, kThreads);
    __syncthreads();
    chunk_count(data, desc, n, tid, kChunk, sym, plan);
    __syncthreads();
    if (lane == 0 && warp < plan->n_blocks) plan_block(plan, warp);
    __syncthreads();
    if (tid == 0) plan_offsets(plan);
    __syncthreads();
    uint32_t bits = block_scan(chunk_bits(data, desc, n, tid, kChunk, sym, plan),
                               warp_sums, &total);
    chunk_write(data, desc, n, tid, kChunk, sym, bits, plan, dst);
    write_stored(data, plan, tid, kThreads, dst);
    if (tid == 0) {
      write_headers(plan, dst);
      out_len[b] = (int)((plan->total_bits + 7) / 8);
    }
    __syncthreads();
  }
}

// The staging of one writer's codec, and the device buffers it shares
// between its two sets (the stream orders them).
struct CardImpl {
  int device;
  int grid;
  cudaStream_t stream;
  cudaEvent_t done[2];
  uint8_t* d_in;
  int32_t* d_in_len;
  uint8_t* d_out;
  int32_t* d_out_len;
  uint32_t* d_crc;
  uint32_t* d_scratch;
};

}  // namespace

extern "C" {

// Deflates payloads k < n (in + k * 65280, in_len[k] bytes) into out + k *
// 65536, out_len[k] bytes, with CRC32 crc[k]; scratch holds n * 65280
// 4-byte words.  At most `grid` blocks.
int ptt_bgzf_deflate(const uint8_t* in, const int32_t* in_len, int n,
                     uint8_t* out, int32_t* out_len, uint32_t* crc,
                     uint32_t* scratch, int grid, void* stream) {
  if (n <= 0) return 0;
  cudaFuncSetAttribute(bgzf_deflate_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  bgzf_deflate_kernel<<<n < grid ? n : grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      in, in_len, n, out, out_len, crc, scratch);
  return cudaGetLastError();
}

static int card_submit(Card* card, int s, int n) {
  CardImpl* im = static_cast<CardImpl*>(card->impl);
  const CardSet& st = card->set[s];
  cudaSetDevice(im->device);
  size_t in_bytes = (size_t)(n - 1) * kMaxPayload + st.in_len[n - 1];
  cudaMemcpyAsync(im->d_in, st.in, in_bytes, cudaMemcpyHostToDevice, im->stream);
  cudaMemcpyAsync(im->d_in_len, st.in_len, n * sizeof(int32_t),
                  cudaMemcpyHostToDevice, im->stream);
  int rc = ptt_bgzf_deflate(im->d_in, im->d_in_len, n, im->d_out, im->d_out_len,
                            im->d_crc, im->d_scratch, im->grid, im->stream);
  if (rc) return rc;
  cudaMemcpyAsync(st.out, im->d_out, (size_t)n * kOutStride,
                  cudaMemcpyDeviceToHost, im->stream);
  cudaMemcpyAsync(st.out_len, im->d_out_len, n * sizeof(int32_t),
                  cudaMemcpyDeviceToHost, im->stream);
  cudaMemcpyAsync(st.crc, im->d_crc, n * sizeof(uint32_t),
                  cudaMemcpyDeviceToHost, im->stream);
  cudaEventRecord(im->done[s], im->stream);
  return cudaGetLastError();
}

static int card_wait(Card* card, int s) {
  CardImpl* im = static_cast<CardImpl*>(card->impl);
  return cudaEventSynchronize(im->done[s]);
}

// A writer's codec on `device`: two pinned staging sets of max_blocks
// payloads, the device buffers, a non-blocking stream and two events that
// block the waiting thread rather than spin.  Null when an allocation
// fails.  Kept for the process.
Card* ptt_bgzf_card_create(int device, int max_blocks, int grid) {
  if (cudaSetDevice(device) != cudaSuccess) return nullptr;
  Card* card = new Card();
  CardImpl* im = new CardImpl();
  card->submit = card_submit;
  card->wait = card_wait;
  card->max_blocks = max_blocks;
  card->impl = im;
  im->device = device;
  im->grid = grid;
  size_t nin = (size_t)max_blocks * kMaxPayload;
  size_t nout = (size_t)max_blocks * kOutStride;
  bool ok = cudaStreamCreateWithFlags(&im->stream, cudaStreamNonBlocking) == cudaSuccess;
  for (int s = 0; s < 2 && ok; ++s) {
    CardSet& st = card->set[s];
    ok = cudaEventCreateWithFlags(&im->done[s], cudaEventBlockingSync |
                                                    cudaEventDisableTiming) == cudaSuccess &&
         cudaMallocHost(&st.in, nin) == cudaSuccess &&
         cudaMallocHost(&st.in_len, max_blocks * sizeof(int32_t)) == cudaSuccess &&
         cudaMallocHost(&st.out, nout) == cudaSuccess &&
         cudaMallocHost(&st.out_len, max_blocks * sizeof(int32_t)) == cudaSuccess &&
         cudaMallocHost(&st.crc, max_blocks * sizeof(uint32_t)) == cudaSuccess;
  }
  ok = ok && cudaMalloc(&im->d_in, nin) == cudaSuccess &&
       cudaMalloc(&im->d_in_len, max_blocks * sizeof(int32_t)) == cudaSuccess &&
       cudaMalloc(&im->d_out, nout) == cudaSuccess &&
       cudaMalloc(&im->d_out_len, max_blocks * sizeof(int32_t)) == cudaSuccess &&
       cudaMalloc(&im->d_crc, max_blocks * sizeof(uint32_t)) == cudaSuccess &&
       cudaMalloc(&im->d_scratch, nin * sizeof(uint32_t)) == cudaSuccess;
  return ok ? card : nullptr;
}

}  // extern "C"
