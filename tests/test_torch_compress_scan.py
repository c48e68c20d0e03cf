"""PyTorch port: kernel 1's per-lane arithmetic (``csrc/compress_scan.h``),
built with g++ and run on emulated lanes exactly as ``csrc/compress.cu``
runs it (segments of odd length, a Hillis-Steele scan within each warp of
32 lanes, warp totals combined in order), equal to
``cleanup_and_compress_plain`` on the kernel-test rows of ``chip_smoke``
(zero lengths, PAD runs, long runs of one code, edge indels), odd K and
overflowing ``max_out`` included.  Run codes and lengths the lanes did not
write show up as a sentinel, so a lane that skips a run fails too."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels.cigar_kernels import cleanup_and_compress_plain

SHIM = r"""
#include <cstdint>
#include <vector>

#include "compress_scan.h"

namespace {

constexpr int32_t kUnwritten = -7;

struct RowOut {
  int32_t* codes;
  int32_t* lens;
  void code(int r, int c) { codes[r] = c; }
  void len(int r, int32_t l) { lens[r] = l; }
};

}  // namespace

// One item at a time, the lanes of compress.cu in turn: 32 * warps lanes.
extern "C" void compress_lanes(const int32_t* codes, const int32_t* lens,
                               int b, int k, int max_out, int warps,
                               int32_t* oc, int32_t* ol, int32_t* n_out,
                               int32_t* shift, uint8_t* overflow) {
  const int lanes = 32 * warps;
  const int seg = ptt::segment_len(k > 0 ? k : 1, lanes);
  std::vector<ptt::RunSummary> incl(lanes), prev(lanes), before(lanes);
  std::vector<int32_t> o_codes(max_out), o_lens(max_out);
  for (int item = 0; item < b; ++item) {
    const int32_t* c_row = codes + (int64_t)item * k;
    const int32_t* l_row = lens + (int64_t)item * k;
    auto lo = [&](int t) { return t * seg < k ? t * seg : k; };
    auto hi = [&](int t) { return lo(t) + seg < k ? lo(t) + seg : k; };
    int first = k, last = -1;
    for (int t = 0; t < lanes; ++t)
      for (int i = lo(t); i < hi(t); ++i)
        if (ptt::is_align_match(c_row[i])) {
          if (i < first) first = i;
          if (i > last) last = i;
        }
    for (int t = 0; t < lanes; ++t) {
      ptt::RunSummary s = ptt::empty_summary();
      for (int i = lo(t); i < hi(t); ++i) {
        int c = c_row[i], l = l_row[i];
        uint32_t sh;
        ptt::clean_op(i, first, last, &c, &l, &sh);
        ptt::summary_push(&s, c, l, sh);
      }
      incl[t] = s;
    }
    // each warp's shuffle scan: every round reads the previous round
    for (int off = 1; off < 32; off <<= 1) {
      prev = incl;
      for (int t = 0; t < lanes; ++t)
        if (t % 32 >= off) incl[t] = ptt::combine(prev[t - off], prev[t]);
    }
    ptt::RunSummary total = ptt::empty_summary();
    for (int w = 0; w < warps; ++w) {
      for (int lane = 0; lane < 32; ++lane) {
        const int t = w * 32 + lane;
        const ptt::RunSummary in_warp =
            lane > 0 ? incl[t - 1] : ptt::empty_summary();
        before[t] = ptt::combine(total, in_warp);
      }
      total = ptt::combine(total, incl[w * 32 + 31]);
    }
    for (int r = 0; r < max_out; ++r) o_codes[r] = o_lens[r] = kUnwritten;
    RowOut out{o_codes.data(), o_lens.data()};
    for (int t = 0; t < lanes; ++t) {
      ptt::Emitter emit(before[t]);
      for (int i = lo(t); i < hi(t); ++i) {
        int c = c_row[i], l = l_row[i];
        uint32_t sh;
        ptt::clean_op(i, first, last, &c, &l, &sh);
        emit.push(c, l, max_out, out);
      }
    }
    if (total.runs > 0 && total.runs - 1 < max_out)
      o_lens[total.runs - 1] = static_cast<int32_t>(total.tail);
    const int n_kept = total.runs < max_out ? total.runs : max_out;
    for (int r = 0; r < max_out; ++r) {
      oc[(int64_t)item * max_out + r] = r < n_kept ? o_codes[r] : ptt::kPad;
      ol[(int64_t)item * max_out + r] = r < n_kept ? o_lens[r] : 0;
    }
    n_out[item] = n_kept;
    shift[item] = static_cast<int32_t>(total.shift);
    overflow[item] = total.runs > max_out ? 1 : 0;
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("compress_scan")
    src = d / "shim.cc"
    src.write_text(SHIM)
    so = d / "shim.so"
    p = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-I", _cuda.CSRC, str(src), "-o", str(so)],
        capture_output=True, text=True,
    )
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.compress_lanes.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp, vp]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def compress_case(rng, b: int, k: int, max_len: int = 24000):
    """``chip_smoke.compress_case``: random op streams with zero lengths, PAD
    runs, long runs of one code and edge indels."""
    codes = rng.integers(0, 10, size=(b, k)).astype(np.int32)
    lens = rng.integers(0, max_len, size=(b, k)).astype(np.int32)
    lens[rng.random((b, k)) < 0.3] = 0
    for i in range(8, b, 3):
        codes[i] = np.repeat(rng.integers(0, 10, size=k // 8 + 1), 8)[:k]
    for i in range(4, b, 5):
        codes[i, rng.integers(0, k):] = 9
    codes[0, :] = 9
    lens[1, :] = 0
    codes[2, :] = 9
    codes[2, 0], lens[2, 0] = 0, 5
    if k >= 4:
        codes[3, :4] = [2, 1, 0, 2]
        lens[3, :4] = [3, 2, 7, 4]
        codes[3, 4:] = 9
    return codes, lens


def _lanes(lib, codes, lens, max_out, warps):
    b, k = codes.shape
    oc = np.empty((b, max_out), np.int32)
    ol = np.empty((b, max_out), np.int32)
    n_out = np.empty(b, np.int32)
    shift = np.empty(b, np.int32)
    overflow = np.empty(b, np.uint8)
    lib.compress_lanes(_ptr(codes), _ptr(lens), b, k, max_out, warps,
                       _ptr(oc), _ptr(ol), _ptr(n_out), _ptr(shift),
                       _ptr(overflow))
    return oc, ol, n_out, shift, overflow.astype(bool)


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("k,max_out", [(352, 232), (464, 232), (257, 128),
                                       (2049, 1024), (33, 8), (5, 3), (1, 1)])
def test_lanes_equal_plain(shim, k, max_out, warps):
    codes, lens = compress_case(np.random.default_rng(k * 10 + warps), 40, k)
    got = _lanes(shim, codes, lens, max_out, warps)
    want = cleanup_and_compress_plain(torch.from_numpy(codes),
                                      torch.from_numpy(lens), max_out)
    for name, g, w in zip(("codes", "lens", "n_out", "shift", "overflow"),
                          got, want):
        assert np.array_equal(g, w.numpy()), name


def test_lanes_stage_b_streams_with_zero_length_ops(shim):
    """Stage-B streams: odd K, zero-length soft clips kept as codes, M runs
    split by zero-length ops, a flush in the row's last ops."""
    rng = np.random.default_rng(5)
    b, k = 24, 257
    codes = np.full((b, k), 9, np.int32)
    lens = np.zeros((b, k), np.int32)
    for i in range(b):
        n = int(rng.integers(1, k + 1))
        codes[i, :n] = rng.choice([0, 0, 0, 1, 2, 4], size=n)
        lens[i, :n] = rng.integers(0, 40, size=n)
        lens[i, :n][rng.random(n) < 0.2] = 0
    codes[0, -1], lens[0, -1] = 0, 9
    got = _lanes(shim, codes, lens, 128, 1)
    want = cleanup_and_compress_plain(torch.from_numpy(codes),
                                      torch.from_numpy(lens), 128)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2].max() > 32  # runs span many lanes' segments


def test_lanes_lengths_past_2_16_and_wrapping(shim):
    """Exact int32 lengths: runs far above 2^16, and sums that wrap past
    2^31 as the plain version's int32 prefix sums do."""
    rng = np.random.default_rng(9)
    codes, lens = compress_case(rng, 16, 352, max_len=2**28)
    codes[9:] = 0  # one long M run per row: its length wraps
    got = _lanes(shim, codes, lens, 232, 1)
    want = cleanup_and_compress_plain(torch.from_numpy(codes),
                                      torch.from_numpy(lens), 232)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert (got[1] > 2**16).any() and (got[1] < 0).any()
