#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one CUDA GPU.

    python3 scripts/torch_kernel_ablations.py [--kernels 1,2,3]

Builds variants of ``portello_tpu_torch/csrc/compress.cu``,
``match_run.cu`` and ``window_match.cu``, and prints the device time per
call of each from ``torch.profiler``, at ``chip_smoke.py``'s shapes and
inputs.  Kernels 1 and 3's variants each leave out one part of the work
(their outputs are wrong by design, so nothing is compared):

- kernel 3 (resident window runs, B=512, C=96 and 512): as built (4 mixed
  pairs per load round); without the window loads (the floor: launch, the
  mask and arguments, the stores); without the genome loads; without the
  packed read loads; with 2 and 8 pairs per load round;
- kernel 1 (cleanup + compress, B=512): as built (4 warps per item, one
  item per block), with 1 and 2 warps per item, with 2 and 4 items per
  block, and with only the staging and the stores (no scan);
- the launch floor: ``fill_`` of 512 int32 on the card.

Kernel 2's variants, at every kernel-2 shape of ``chip_smoke.py`` phase 3
(dense C=96 and 512 both directions, the edge shapes, stage A's homology
runs, and the calls the table and reverse steps make, recorded on the
B=512 batch), each built with ``-Xptxas -v`` (its register counts are
printed): as built (one thread per pair, every granule loaded before any
compare); with the arguments loaded by ``__ldg`` (the compiler then sinks
the starts' loads under the test of the limit); with a 1D grid and the
item found by division; with the limit tested only by the compare loop;
the byte walk it replaced (one thread per pair, one dependent byte load
per position, ``WALK`` below); a warp per 32 pairs (``WARP``: a ballot of
the live pairs, then 4 pairs at a time, one position per lane); 4 lanes
per live pair (``COOP``: one granule per lane); and, wrong by design, as
built with only 2 granules per row, and without the data loads (the
floor: launch, arguments, stores).  Every variant but the last two must
equal ``match_run_plain`` at every shape.

The card's name and power limit are printed first.  Needs one card, nvcc
and the repo on the path; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from portello_tpu_torch.kernels import _cuda  # noqa: E402

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# The kernel that the per-thread granule form replaced: one thread per pair
# walks its compare byte by byte, each load waiting on the previous compare.
WALK = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void match_run_kernel(
    const uint8_t* __restrict__ a, int len_a, const uint8_t* __restrict__ b,
    int len_b, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    const int32_t* __restrict__ limit, int n_items, int n_clusters,
    int window, int rev, int32_t* __restrict__ run_out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_items * n_clusters) return;
  const long long item = k / n_clusters;
  const uint8_t* ra = a + item * len_a;
  const uint8_t* rb = b + item * len_b;
  int lim = __ldg(limit + k);
  lim = lim < 0 ? 0 : (lim > window ? window : lim);
  const long long sa = __ldg(ia + k), sb = __ldg(ib + k);
  const long long step = rev ? -1 : 1;
  long long pa = rev ? sa - 1 : sa;
  long long pb = rev ? sb - 1 : sb;
  int run = 0;
  for (; run < lim; ++run, pa += step, pb += step) {
    const int va = (pa >= 0 && pa < len_a) ? __ldg(ra + pa) : 0xFE;
    const int vb = (pb >= 0 && pb < len_b) ? __ldg(rb + pb) : 0xFD;
    if (va != vb) break;
  }
  run_out[k] = run;
}

}  // namespace

extern "C" int ptt_match_run(const void* a, int len_a, const void* b,
                             int len_b, const void* ia, const void* ib,
                             const void* limit, int n_items, int n_clusters,
                             int window, int rev, void* run, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    match_run_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), len_a,
        static_cast<const uint8_t*>(b), len_b,
        static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        static_cast<const int32_t*>(limit), n_items, n_clusters, window, rev,
        static_cast<int32_t*>(run));
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# Kernel 2 in the form of kernel 3's resident entry: a warp owns 32 pairs,
# ballots those with a limit above 0, and takes them 4 at a time; for each,
# lane l loads positions base + l and base + l + 32 of both rows (byte
# loads, all issued before any compare), and one ballot per half gives the
# mismatch mask.  A window above 64 takes a next round of 64 positions for
# the pairs whose previous one matched in full.
WARP = r"""
#include <cuda_runtime.h>

#include <cstdint>

#include "window_runs.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int row_byte(const uint8_t* row, int len,
                                        long long p, int fill) {
  return (p >= 0 && p < len) ? __ldg(row + p) : fill;
}

template <bool kRev>
__global__ void __launch_bounds__(kThreads) match_run_kernel(
    const uint8_t* __restrict__ a, int len_a, const uint8_t* __restrict__ b,
    int len_b, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    const int32_t* __restrict__ limit, int n_items, int n_clusters,
    int window, int32_t* __restrict__ run_out) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)n_items * n_clusters;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (first >= total) return;  // warp-uniform
  const long long k = first + lane;
  const bool in = k < total;
  int lim = in ? __ldg(limit + k) : 0;
  lim = lim < 0 ? 0 : (lim > window ? window : lim);
  const int my_a = in ? __ldg(ia + k) : 0;
  const int my_b = in ? __ldg(ib + k) : 0;
  const long long my_item = in ? k / n_clusters : 0;
  int run = 0;
  bool going = lim > 0;
  for (int base = 0;; base += 64) {
    unsigned todo = __ballot_sync(kFull, going);
    if (!todo) break;  // warp-uniform
    while (todo) {     // warp-uniform
      int src[kGroup], plim[kGroup], va[kGroup][2], vb[kGroup][2];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        src[g] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const int s = src[g] < 0 ? 0 : src[g];
        const int p_a = __shfl_sync(kFull, my_a, s);
        const int p_b = __shfl_sync(kFull, my_b, s);
        const long long p_item = __shfl_sync(kFull, my_item, s);
        plim[g] = __shfl_sync(kFull, lim, s);
        va[g][0] = va[g][1] = vb[g][0] = vb[g][1] = 0;
        if (src[g] >= 0) {
          const uint8_t* ra = a + p_item * len_a;
          const uint8_t* rb = b + p_item * len_b;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = base + lane + 32 * h;
            if (t < plim[g]) {
              const long long pa = kRev ? (long long)p_a - 1 - t
                                        : (long long)p_a + t;
              const long long pb = kRev ? (long long)p_b - 1 - t
                                        : (long long)p_b + t;
              va[g][h] = row_byte(ra, len_a, pa, 0xFE);
              vb[g][h] = row_byte(rb, len_b, pb, 0xFD);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (src[g] < 0) break;  // warp-uniform
        const int t0 = base + lane;
        const bool d0 = t0 < plim[g] && va[g][0] != vb[g][0];
        const bool d1 = t0 + 32 < plim[g] && va[g][1] != vb[g][1];
        const uint64_t mis = __ballot_sync(kFull, d0) |
                             (uint64_t(__ballot_sync(kFull, d1)) << 32);
        const int n = plim[g] - base < 64 ? plim[g] - base : 64;
        const int r = ptt::leading_run_from_mismatch(mis, n);
        if (lane == src[g]) {
          run += r;
          going = r == 64 && plim[g] > base + 64;
        }
      }
    }
  }
  if (in) run_out[k] = run;
}

}  // namespace

extern "C" int ptt_match_run(const void* a, int len_a, const void* b,
                             int len_b, const void* ia, const void* ib,
                             const void* limit, int n_items, int n_clusters,
                             int window, int rev, void* run, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    auto kernel = rev ? match_run_kernel<true> : match_run_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), len_a,
        static_cast<const uint8_t*>(b), len_b,
        static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        static_cast<const int32_t*>(limit), n_items, n_clusters, window,
        static_cast<int32_t*>(run));
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def variant(source: str, edits: dict) -> str:
    """``source`` with each old -> new edit applied exactly once."""
    for old, new in edits.items():
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source


def build(d: str, name: str, source: str, registers: str = ""):
    """Compile ``source`` into a library of its own; with ``registers``
    set, print ptxas's register and spill lines under that label."""
    path = os.path.join(d, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    so = os.path.join(d, f"{name}.so")
    verbose = ("-Xptxas", "-v") if registers else ()
    p = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *verbose, "-I",
                        _cuda.CSRC, "-shared", "-o", so, path],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{p.stderr[-3000:]}")
    for line in p.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas ({registers}): {line.strip()}", flush=True)
    return ctypes.CDLL(so, mode=ctypes.RTLD_LOCAL)


def us(fn) -> str:
    return f"{cs.call_ms(fn)[0] * 1e3:.2f} us"


def window_variants(d: str) -> dict:
    with open(os.path.join(_cuda.CSRC, "window_match.cu")) as f:
        src = f.read()
    loads = {
        "genome": ("v[g][0] = p.ref_r(t0);", "v[g][2] = p.ref_l(t0);",
                   "v[g][4] = p.ref_r(t1);", "v[g][6] = p.ref_l(t1);"),
        "read": ("v[g][1] = p.read_r.raw(t0);", "v[g][3] = p.read_l.raw(t0);",
                 "v[g][5] = p.read_r.raw(t1);", "v[g][7] = p.read_l.raw(t1);"),
    }
    sources = {
        "as built": src,
        "no window loads": variant(src, {
            "  while (todo) {  // warp-uniform":
            "  todo = 0;\n  while (todo) {  // warp-uniform"}),
        # a constant 'A' byte, and a packed byte that decodes to 'A'
        "no genome loads": variant(src, {
            s: s.split("=")[0] + "= 65;" for s in loads["genome"]}),
        "no read loads": variant(src, {
            s: s.split("=")[0] + "= 0x11;" for s in loads["read"]}),
        "2 pairs per load round": variant(src, {
            "constexpr int kGroup = 4;": "constexpr int kGroup = 2;"}),
        "8 pairs per load round": variant(src, {
            "constexpr int kGroup = 4;": "constexpr int kGroup = 8;"}),
    }
    libs = {}
    for i, (name, source) in enumerate(sources.items()):
        lib = build(d, f"window{i}", source)
        lib.ptt_window_runs_resident.restype = I
        lib.ptt_window_runs_resident.argtypes = [
            P, LL, P, P, I, P, P, P, P, P, I, I, I, P, P, P]
        libs[name] = lib
    return libs


def compress_variants(d: str) -> dict:
    with open(os.path.join(_cuda.CSRC, "compress.cu")) as f:
        src = f.read()
    warps = "constexpr int kWarpsPerItem = 4;"
    sources = {
        "as built": src,
        "1 warp per item": variant(src, {warps: warps.replace("4", "1")}),
        "2 warps per item": variant(src, {warps: warps.replace("4", "2")}),
        "2 items per block": variant(src, {
            "constexpr int kThreads = 128;": "constexpr int kThreads = 256;"}),
        "4 items per block": variant(src, {
            "constexpr int kThreads = 128;": "constexpr int kThreads = 512;"}),
        "staging and stores only": variant(src, {
            "const int kk = live ? k : 0;": "const int kk = 0;"}),
    }
    libs = {}
    for i, (name, source) in enumerate(sources.items()):
        lib = build(d, f"compress{i}", source)
        lib.ptt_cleanup_and_compress.restype = I
        lib.ptt_cleanup_and_compress.argtypes = [P, P, I, I, I, P, P, P, P,
                                                 P, P]
        libs[name] = lib
    return libs


# Kernel 2 with a warp per 32 pairs and 4 lanes per live pair: the warp
# ballots the pairs with a limit above 0 and takes them 8 at a time, up to
# kRounds groups of 8 whose loads all go out before any compare.  Lane s of
# a pair loads aligned granule s of both rows' 48-position spans (the 4
# lanes read 64 contiguous bytes, one or two L1 requests per row and pair),
# takes the next granule from lane s + 1, realigns its 16 span bytes, and
# the first mismatch of the 4 lanes comes from two shuffles.
COOP = r"""
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 48;
constexpr int kRounds = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Lane {
  uint32_t g[4];
  int o, lo, hi;
};

__device__ __forceinline__ int clamp64i(long long v) {
  return v < 0 ? 0 : (v > 64 ? 64 : (int)v);
}

// Granule `sub` of span [s, s + kSpan) of a row, loaded if it holds a byte
// of both the compared span bytes [need_lo, need_hi) and the row.
__device__ __forceinline__ Lane load_lane(const uint8_t* row, int len,
                                          long long s, int need_lo,
                                          int need_hi, int sub, bool has,
                                          uint32_t fill) {
  Lane l;
  l.o = (int)(((unsigned long long)(uintptr_t)row + (unsigned long long)s) &
              15);
  const long long r = s - l.o + 16 * sub;
  if (has && 16 * sub + 16 > l.o + need_lo && 16 * sub < l.o + need_hi &&
      r < len && r + 16 > 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + r));
    l.g[0] = v.x; l.g[1] = v.y; l.g[2] = v.z; l.g[3] = v.w;
  } else {
    l.g[0] = l.g[1] = l.g[2] = l.g[3] = fill;
  }
  l.lo = clamp64i(-s);
  l.hi = clamp64i((long long)len - s);
  return l;
}

// Words q and q + 1 of the lane's 16 span bytes, from its granule and the
// next lane's (w[0..7]), with the fill outside the row when `fill_on`.
__device__ __forceinline__ uint32_t lane_word(const uint32_t* w, int q,
                                              int o, bool fill_on, int lo,
                                              int hi, int sub, uint32_t fill) {
  const bool p1 = (o >> 2) & 1, p2 = (o >> 3) & 1;
  const uint32_t x0 = p2 ? (p1 ? w[q + 3] : w[q + 2]) : (p1 ? w[q + 1] : w[q]);
  const uint32_t x1 = p2 ? (p1 ? w[q + 4] : w[q + 3]) : (p1 ? w[q + 2] : w[q + 1]);
  uint32_t v = __funnelshift_r(x0, x1, (o & 3) * 8);
  if (fill_on) {
    const uint32_t idx = 0x03020100u + 0x04040404u * (4 * sub + q);
    const uint32_t in = __vcmpgeu4(idx, lo * 0x01010101u) &
                        __vcmpltu4(idx, hi * 0x01010101u);
    v = (v & in) | (fill & ~in);
  }
  return v;
}

template <bool kRev>
__device__ __forceinline__ int group_run(const Lane& la, const Lane& lb,
                                         int sub, int n) {
  uint32_t wa[8], wb[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wa[i] = la.g[i];
    wb[i] = lb.g[i];
    wa[4 + i] = __shfl_down_sync(kFull, la.g[i], 1);
    wb[4 + i] = __shfl_down_sync(kFull, lb.g[i], 1);
  }
  const bool fa = la.lo > 16 * sub || la.hi < 16 * sub + 16;
  const bool fb = lb.lo > 16 * sub || lb.hi < 16 * sub + 16;
  // span position of this lane's first (forward) or last (backward)
  // mismatch; none: 64 forward, -1 backward
  int best = kRev ? -1 : 64;
  if (sub < 3) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = kRev ? 3 - i : i;
      const uint32_t x =
          lane_word(wa, q, la.o, fa, la.lo, la.hi, sub, 0xFEFEFEFEu) ^
          lane_word(wb, q, lb.o, fb, lb.lo, lb.hi, sub, 0xFDFDFDFDu);
      if (x) {
        best = 16 * sub + 4 * q +
               (kRev ? 3 - (__clz((int)x) >> 3) : (__ffs((int)x) - 1) >> 3);
        break;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    const int other = __shfl_xor_sync(kFull, best, m);
    best = kRev ? max(best, other) : min(best, other);
  }
  const int r = kRev ? kSpan - 1 - best : best;
  return r < n ? r : n;
}

template <bool kRev>
__global__ void __launch_bounds__(kThreads) match_run_kernel(
    const uint8_t* __restrict__ a, int len_a, const uint8_t* __restrict__ b,
    int len_b, const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
    const int32_t* __restrict__ limit, int n_items, int n_clusters,
    int window, int32_t* __restrict__ run_out) {
  const int lane = threadIdx.x & 31;
  const int slot = lane >> 2, sub = lane & 3;
  const long long total = (long long)n_items * n_clusters;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (first >= total) return;  // warp-uniform
  const long long k = first + lane;
  const bool in = k < total;
  int lim = in ? __ldg(limit + k) : 0;
  lim = lim < 0 ? 0 : (lim > window ? window : lim);
  const int my_a = in ? __ldg(ia + k) : 0;
  const int my_b = in ? __ldg(ib + k) : 0;
  const long long my_item = in ? k / n_clusters : 0;
  int run = 0;
  bool going = lim > 0;
  for (int base = 0;; base += kSpan) {
    const unsigned live = __ballot_sync(kFull, going);
    if (!live) break;  // warp-uniform
    const int n_live = __popc(live);
    const int my_rank = __popc(live & ((1u << lane) - 1u));
    for (int r0 = 0; r0 < n_live; r0 += 8 * kRounds) {  // warp-uniform
      Lane la[kRounds], lb[kRounds];
      int nn[kRounds];
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const int rank = r0 + 8 * j + slot;
        const bool has = rank < n_live;
        const int src = has ? (int)__fns(live, 0, rank + 1) : 0;
        const int p_a = __shfl_sync(kFull, my_a, src);
        const int p_b = __shfl_sync(kFull, my_b, src);
        const int p_lim = __shfl_sync(kFull, lim, src);
        const long long p_item = __shfl_sync(kFull, my_item, src);
        const int n = has ? min(p_lim - base, kSpan) : 0;
        nn[j] = n;
        const int need_lo = kRev ? kSpan - n : 0, need_hi = kRev ? kSpan : n;
        const long long sa = kRev ? (long long)p_a - base - kSpan
                                  : (long long)p_a + base;
        const long long sb = kRev ? (long long)p_b - base - kSpan
                                  : (long long)p_b + base;
        la[j] = load_lane(a + p_item * len_a, len_a, sa, need_lo, need_hi,
                          sub, has, 0xFEFEFEFEu);
        lb[j] = load_lane(b + p_item * len_b, len_b, sb, need_lo, need_hi,
                          sub, has, 0xFDFDFDFDu);
      }
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        if (r0 + 8 * j >= n_live) break;  // warp-uniform
        const int r = group_run<kRev>(la[j], lb[j], sub, nn[j]);
        const int owner = my_rank - r0 - 8 * j;
        const int got = __shfl_sync(kFull, r, (owner & 7) * 4);
        if (((live >> lane) & 1) && owner >= 0 && owner < 8) {
          run += got;
          going = got == kSpan && lim > base + kSpan;
        }
      }
    }
  }
  if (in) run_out[k] = run;
}

}  // namespace

extern "C" int ptt_match_run(const void* a, int len_a, const void* b,
                             int len_b, const void* ia, const void* ib,
                             const void* limit, int n_items, int n_clusters,
                             int window, int rev, void* run, void* stream) {
  const long long total = (long long)n_items * n_clusters;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    auto kernel = rev ? match_run_kernel<true> : match_run_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), len_a,
        static_cast<const uint8_t*>(b), len_b,
        static_cast<const int32_t*>(ia), static_cast<const int32_t*>(ib),
        static_cast<const int32_t*>(limit), n_items, n_clusters, window,
        static_cast<int32_t*>(run));
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# Kernel 2's variants whose runs must equal the plain version's.
MATCH_RUN_EXACT = ("as built", "arguments loaded by __ldg",
                   "1D grid, division after the loads",
                   "limit tested by the loop alone", "byte walk",
                   "warp per 32 pairs", "4 lanes per pair")


def match_run_variants(d: str) -> dict:
    with open(os.path.join(_cuda.CSRC, "match_run.cu")) as f:
        src = f.read()
    with open(os.path.join(_cuda.CSRC, "match_run.h")) as f:
        header = f.read()
    sources = {
        "as built": src,
        "arguments loaded by __ldg": variant(src, {
            "const int32_t lim = load_arg(limit + k);\n"
            "    const int32_t sa = load_arg(ia + k), sb = load_arg(ib + k);":
            "const int32_t lim = __ldg(limit + k);\n"
            "    const int32_t sa = __ldg(ia + k), sb = __ldg(ib + k);"}),
        "1D grid, division after the loads": variant(src, {
            "  const int c = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  if (c >= n_clusters) return;\n"
            "  for (long long item = blockIdx.y; item < n_items; "
            "item += gridDim.y) {\n"
            "    const long long k = item * n_clusters + c;":
            "  const long long k = (long long)blockIdx.x * blockDim.x + "
            "threadIdx.x;\n"
            "  if (k >= (long long)n_items * n_clusters) return;\n  {",
            "    run_out[k] = ptt::match_run_one<kRev>(a + item * len_a, len_a,":
            "    const long long item = k / n_clusters;\n"
            "    run_out[k] = ptt::match_run_one<kRev>(a + item * len_a, len_a,",
            "    const dim3 grid((n_clusters + threads - 1) / threads,\n"
            "                    n_items < kMaxGridY ? n_items : kMaxGridY);":
            "    const dim3 grid((unsigned)(((long long)n_items * n_clusters + "
            "kThreads - 1) / kThreads));",
            "kernel<<<grid, threads,": "kernel<<<grid, kThreads,"}),
        "byte walk": WALK,
        "warp per 32 pairs": WARP,
        "4 lanes per pair": COOP,
        "limit tested by the loop alone": variant(src, {
            '#include "match_run.h"': variant(header, {
                "return lim > 0 ? match_run_pair<kRev>(ra, len_a, rb, len_b, "
                "ia, ib, lim) : 0;":
                "return match_run_pair<kRev>(ra, len_a, rb, len_b, ia, ib, "
                "lim);"})}),
        # granules 2-4 never loaded: wrong runs, half the vector loads
        "2 granules per row": variant(src, {
            '#include "match_run.h"': variant(header, {
                "if (16 * k + 16 > o + need_lo":
                "if (k < 2 && 16 * k + 16 > o + need_lo"})}),
        "no data loads": variant(src, {
            "    run_out[k] = ptt::match_run_one<kRev>(":
            "    run_out[k] = lim ^ sa ^ sb;\n"
            "    if (false) ptt::match_run_one<kRev>("}),
    }
    libs = {}
    for i, (name, source) in enumerate(sources.items()):
        lib = build(d, f"match_run{i}", source, registers=f"kernel 2, {name}")
        lib.ptt_match_run.restype = I
        lib.ptt_match_run.argtypes = [P, I, P, I, P, P, P, I, I, I, I, P, P]
        libs[name] = lib
    return libs


def match_run_cases(dev) -> list:
    """(label, args) of every kernel-2 shape of chip_smoke.py phase 3, args
    as ``match_run_cuda`` takes them, from a seed of their own."""
    rng = np.random.default_rng(cs.SEED + 1)
    rev_arrays = cs.hifi_batch(rng)
    cases = cs.match_run_dense_cases(rng, dev) + cs.match_run_edge_cases(dev)
    for label, _, _, homology, w, _ in cs.reverse_step_cases(rng, rev_arrays,
                                                             dev):
        cases.append((f"stage A, {label}", (*homology, w, True)))
    cases += [(label, args)
              for label, args, _ in cs.captured_match_runs(rev_arrays, dev)]
    return cases


def ablate_match_run(d: str, stream) -> None:
    from portello_tpu_torch.kernels.cluster_utils import match_run_plain

    libs = match_run_variants(d)
    for label, args in match_run_cases(torch.device("cuda")):
        seq_a, sa, seq_b, sb, limit, w, rev = args
        b, c = limit.shape
        want = match_run_plain(*args)
        out = torch.empty_like(want)
        row = []
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.ptt_match_run(
                    seq_a.data_ptr(), seq_a.shape[1], seq_b.data_ptr(),
                    seq_b.shape[1], sa.data_ptr(), sb.data_ptr(),
                    limit.data_ptr(), b, c, w, int(rev), out.data_ptr(),
                    stream())
                assert rc == 0, rc
            if name in MATCH_RUN_EXACT:
                out.fill_(-1)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"kernel 2 {name}, {label}: runs differ "
                                       f"from the plain version")
            row.append(f"{name} {us(run)}")
        print(f"kernel 2 {label} B={b} C={c} W={w} L={seq_a.shape[1]} "
              f"{'backward' if rev else 'forward'} ({int((limit > 0).sum())} "
              f"live pairs; {', '.join(MATCH_RUN_EXACT)} equal to the plain "
              f"version): " + "; ".join(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="1,2,3",
                    help="which kernels to ablate, comma-separated")
    which = set(ap.parse_args().kernels.split(","))
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="ptt_ablate_") as d:
        if "2" in which:
            ablate_match_run(d, stream)
        if "3" in which:
            ablate_window_match(d, rng, stream)
        if "1" in which:
            ablate_compress(d, rng, stream)
    z = torch.empty(512, dtype=torch.int32, device="cuda")
    print(f"launch floor: fill_ of 512 int32 {us(lambda: z.fill_(1))}",
          flush=True)
    return 0


def ablate_window_match(d: str, rng, stream) -> None:
    wlibs = window_variants(d)
    genome = cs.device_genome(cs.GENOME_BYTES, cs.SEED)
    n = genome.shape[0]
    for c, max_seq in ((96, 24576), (512, 65536)):
        bases = rng.integers(0, n - max_seq, size=512).astype(np.int64)
        g, gb, packed, bs, rs, dl, il, mixed = cs.resident_case(
            rng, genome, bases, c, max_seq)
        b = packed.shape[0]
        rr = torch.empty((b, c), dtype=torch.int32, device="cuda")
        rl = torch.empty_like(rr)
        row = []
        for name, lib in wlibs.items():
            def run(lib=lib):
                rc = lib.ptt_window_runs_resident(
                    g.data_ptr(), n, gb.data_ptr(), packed.data_ptr(),
                    packed.shape[1], bs.data_ptr(), rs.data_ptr(),
                    dl.data_ptr(), il.data_ptr(), mixed.data_ptr(), b, c,
                    cs.W, rr.data_ptr(), rl.data_ptr(), stream())
                assert rc == 0, rc
            row.append(f"{name} {us(run)}")
        print(f"kernel 3 resident B=512 C={c} ({int(mixed.sum())} mixed): "
              + "; ".join(row), flush=True)
    del genome
    torch.cuda.empty_cache()


def ablate_compress(d: str, rng, stream) -> None:
    clibs = compress_variants(d)
    for k, max_out in ((352, 232), (464, 232), (2816, 1800), (3600, 1800),
                       (257, 128), (2049, 1024)):
        codes, lens = cs.compress_case(rng, 512, k)
        ct = torch.from_numpy(codes).cuda()
        lt = torch.from_numpy(lens).cuda()
        oc = torch.empty((512, max_out), dtype=torch.int32, device="cuda")
        ol = torch.empty_like(oc)
        no = torch.empty(512, dtype=torch.int32, device="cuda")
        sh = torch.empty_like(no)
        ov = torch.empty(512, dtype=torch.bool, device="cuda")
        row = []
        for name, lib in clibs.items():
            def run(lib=lib):
                rc = lib.ptt_cleanup_and_compress(
                    ct.data_ptr(), lt.data_ptr(), 512, k, max_out,
                    oc.data_ptr(), ol.data_ptr(), no.data_ptr(),
                    sh.data_ptr(), ov.data_ptr(), stream())
                assert rc == 0, rc
            row.append(f"{name} {us(run)}")
        print(f"kernel 1 B=512 K={k} max_out={max_out}: " + "; ".join(row),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
