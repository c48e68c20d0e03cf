"""PyTorch port, kernel 2 (``csrc/match_run.cu``): its per-pair body
(``csrc/match_run.h``) built with g++ and run pair by pair, as each CUDA
thread runs it, on rows laid out in one flat buffer at every alignment, and
held against the plain version ``match_run_plain`` and JAX's gather form
``match_run_left``/``match_run_right`` with tolerance 0.  The host build
reads the same aligned 16-byte granules as the kernel, bytes of the
neighbouring rows and of the buffer's slack included, so a byte outside a
row that is not replaced by its side's fill shows up as a wrong run.
(The CUDA kernel itself runs only on a GPU: ``chip_smoke.py`` checks it
there.)"""

import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from portello_tpu.kernels import cluster_utils as jcu
from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels import cluster_utils as tcu

SHIM = r"""
#include "match_run.h"

extern "C" void match_runs(const uint8_t* a, int64_t len_a, const uint8_t* b,
                           int64_t len_b, const int32_t* ia,
                           const int32_t* ib, const int32_t* limit,
                           int n_items, int n_clusters, int window, int rev,
                           int32_t* run) {
  for (int64_t k = 0; k < int64_t(n_items) * n_clusters; ++k) {
    const int64_t item = k / n_clusters;
    const uint8_t* ra = a + item * len_a;
    const uint8_t* rb = b + item * len_b;
    run[k] = rev ? ptt::match_run_one<true>(ra, len_a, rb, len_b, ia[k],
                                            ib[k], limit[k], window)
                 : ptt::match_run_one<false>(ra, len_a, rb, len_b, ia[k],
                                             ib[k], limit[k], window);
  }
}

// Span [s, s + 64) of a row as SpanRow gives it: its 16 words (filled or
// as loaded), then its partial flag.
extern "C" void span_bytes(const uint8_t* row, int64_t len, int64_t s,
                           int need_lo, int need_hi, int filled,
                           uint8_t* out) {
  const ptt::SpanRow r(row, len, s, need_lo, need_hi, ptt::kFillA4);
  for (int q = 0; q < 16; ++q) {
    const uint32_t w = filled ? r.filled(q) : r.word(q);
    std::memcpy(out + 4 * q, &w, 4);
  }
  out[64] = r.partial;
}
"""

SLACK = 48  # buffer bytes before the first row and after the last


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("match_run")
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
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.match_runs.argtypes = [vp, ll, vp, ll, vp, vp, vp, i, i, i, i, vp]
    lib.span_bytes.argtypes = [vp, ll, ll, i, i, i, vp]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _flat(rows, offset, slack_byte):
    """``rows`` copied into one flat buffer whose first row starts
    ``offset`` bytes past a 16-byte boundary, with ``SLACK`` bytes of
    ``slack_byte`` on both sides; returns (buffer, first row's index)."""
    n = rows.size
    buf = np.full(n + 2 * SLACK + 32, slack_byte, np.uint8)
    start = (-buf.ctypes.data) % 16 + SLACK + offset
    buf[start:start + n] = rows.ravel()
    return buf, start


def _shim_runs(lib, a, b, ia, ib, limit, window, rev, offset=0):
    """The header's runs, rows of a at ``offset`` and of b at ``offset``
    + 5 from a 16-byte boundary.  The slack holds the same byte on both
    sides, so only the fills keep it from matching."""
    abuf, a0 = _flat(a, offset, 65)
    bbuf, b0 = _flat(b, (offset + 5) % 16, 65)
    n_items, c = ia.shape
    run = np.full((n_items, c), -7, np.int32)
    ia, ib, limit = (np.ascontiguousarray(x, np.int32) for x in (ia, ib, limit))
    lib.match_runs(abuf[a0:].ctypes.data, a.shape[1], bbuf[b0:].ctypes.data,
                   b.shape[1], _ptr(ia), _ptr(ib), _ptr(limit), n_items, c,
                   window, int(rev), _ptr(run))
    return run


def _rows(rng, n_items, length):
    """Rows of a and b, mostly equal: mutations, zero padding at the rows'
    ends (equal in the last 16 bytes), in-row bytes equal to the other
    side's fill at the rows' starts, and one row without mismatches."""
    a = rng.integers(65, 69, size=(n_items, length), dtype=np.uint8)
    b = a.copy()
    mut = rng.random((n_items, length)) < 0.03
    b[mut] = rng.integers(60, 64, size=int(mut.sum()), dtype=np.uint8)
    a[:, -16:] = 0
    b[:, -40:] = 0
    b[::2, :3] = tcu.FILL_A   # in-row 0xFE against a's fill before its row
    a[1::2, :3] = tcu.FILL_B  # and 0xFD against b's
    b[0] = a[0]
    return a, b


def _args(rng, n_items, c, window, length, lo=None, hi=None):
    """Starts over [lo, hi] (default [-W, len]), 70% of them equal on both
    sides, with the domain's ends and one-sided ends in the first columns;
    limits <= 0, inside the window and above it."""
    lo = -window if lo is None else lo
    hi = length if hi is None else hi
    ia = rng.integers(lo, hi + 1, size=(n_items, c))
    ib = np.where(rng.random((n_items, c)) < 0.7, ia,
                  np.clip(ia + rng.integers(-3, 4, size=(n_items, c)), lo, hi))
    ends = [(-window, -window), (0, 0), (length, length), (-1, 0), (0, -1),
            (length, length - 1), (length - 1, length), (lo, hi)]
    for j, (x, y) in enumerate(ends):
        ia[:, j], ib[:, j] = x, y
    limit = rng.integers(-3, window + 10, size=(n_items, c))
    limit[:, len(ends):len(ends) + 4] = [-1, 0, window, window + 8]
    limit[0] = window + 8  # the matching row saturates every window
    return (x.astype(np.int32) for x in (ia, ib, limit))


def _plain(a, b, ia, ib, limit, window, rev):
    return tcu.match_run_plain(*map(torch.from_numpy, (a, ia, b, ib, limit)),
                               window, rev).numpy()


def _jax(a, b, ia, ib, limit, window, rev):
    fn = jcu.match_run_right if rev else jcu.match_run_left
    return np.asarray(jax.vmap(
        lambda x, i, y, j, m: fn(x, i, y, j, m, window)[0]
    )(a, ia, b, ib, limit))


def _jax_domain(idx, length, window, rev):
    """Pairs whose JAX windows read no clamped index: JAX's gather pads each
    row with ``pad`` fill bytes and clamps a window's start into the padded
    row, which moves a window that reaches past the padding."""
    pad = window // 4 * 4 + 4
    s = idx - window if rev else idx
    return (s >= -pad) & (s <= length + pad - window - 4)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("window", [1, 31, 32, 33, 48, 64, 100])
def test_header_equals_plain_and_jax(shim, window, rev):
    """Rows of 300 bytes (a multiple of 4, as JAX's gather form needs, and
    not of 16), so row starts fall at four offsets from a 16-byte boundary;
    starts over [-W, len] (backward: window ends over [0, len], whose
    windows lie in [-W, len]); every pair against the plain version, the
    pairs inside JAX's domain against JAX."""
    rng = np.random.default_rng(window * 2 + rev)
    n_items, c, length = 16, 48, 300
    a, b = _rows(rng, n_items, length)
    ia, ib, limit = _args(rng, n_items, c, window, length,
                          lo=0 if rev else -window)
    got = _shim_runs(shim, a, b, ia, ib, limit, window, rev, offset=window % 16)
    want = _plain(a, b, ia, ib, limit, window, rev)
    assert np.array_equal(got, want)
    ok = (_jax_domain(ia, length, window, rev)
          & _jax_domain(ib, length, window, rev))
    assert ok.mean() > 0.9
    assert np.array_equal(got[ok], _jax(a, b, ia, ib, limit, window, rev)[ok])
    lim = np.clip(limit, 0, window)
    assert (got == lim)[lim > 0].any() and (got < lim).any()
    assert (got[0] == window).any()


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("offset", [0, 1, 8, 15])
def test_header_odd_rows_and_far_starts_equal_plain(shim, offset, rev):
    """Rows of 301 bytes, so row starts fall at every offset from a 16-byte
    boundary; starts far outside the rows; windows 48 and 100."""
    rng = np.random.default_rng(100 + offset * 2 + rev)
    n_items, c, length = 16, 40, 301
    a, b = _rows(rng, n_items, length)
    for window in (48, 100):
        ia, ib, limit = _args(rng, n_items, c, window, length,
                              lo=-3 * window, hi=length + 3 * window)
        ia[:, -2:], ib[:, -2:] = [-10**6, 10**6], [10**6, -10**6]
        got = _shim_runs(shim, a, b, ia, ib, limit, window, rev, offset)
        assert np.array_equal(got, _plain(a, b, ia, ib, limit, window, rev))
        assert (got[0] == window).any()


def test_header_fills_against_in_row_bytes(shim):
    """A position outside a row reads its side's fill, which equals an
    in-row byte of that value on the other side; outside both rows the two
    fills differ.  Row bytes are 0xFE on a, 0xFD on b, len 20."""
    a = np.full((1, 20), tcu.FILL_B, np.uint8)
    b = np.full((1, 20), tcu.FILL_A, np.uint8)
    ia = np.array([[-3, 0, 18, -40, 20]], np.int32)
    ib = np.array([[0, -3, 20, -40, 20]], np.int32)
    limit = np.full((1, 5), 48, np.int32)
    for rev in (False, True):
        got = _shim_runs(shim, a, b, ia, ib, limit, 48, rev, offset=3)
        want = _plain(a, b, ia, ib, limit, 48, rev)
        assert np.array_equal(got, want), rev
    # forward: from (-3, 0) a's fill 0xFE meets b's in-row 0xFE three times,
    # then a's 0xFD meets b's 0xFE; from (18, 20) a's in-row 0xFD meets b's
    # fill 0xFD twice; outside both rows the fills differ
    fwd = _shim_runs(shim, a, b, ia, ib, limit, 48, False)
    assert fwd.tolist() == [[3, 3, 2, 0, 0]]


@pytest.mark.parametrize("offset", range(16))
def test_header_span_realigns_and_fills(shim, offset):
    """SpanRow on a 77-byte row that starts ``offset`` bytes past a 16-byte
    boundary, for spans from before the row to past its end: each compared
    byte (the whole span, the first n, the last n) is the row's byte, or
    the fill outside the row, and ``partial`` says whether a compared byte
    lies outside.  Unfilled words hold the row's bytes where they lie in
    it."""
    rng = np.random.default_rng(offset)
    length = 77
    row = rng.integers(0, 256, size=(1, length), dtype=np.uint8)
    buf, r0 = _flat(row, offset, tcu.FILL_B)
    out = np.empty(65, np.uint8)
    for s in range(-70, length + 6, 3):
        for need_lo, need_hi in ((0, 64), (0, 17), (64 - 33, 64), (0, 1)):
            pos = s + np.arange(64)
            inside = (pos >= 0) & (pos < length)
            want = np.where(inside, row[0, pos.clip(0, length - 1)],
                            tcu.FILL_A)
            need = slice(need_lo, need_hi)
            shim.span_bytes(buf[r0:].ctypes.data, length, s, need_lo, need_hi,
                            1, _ptr(out))
            assert np.array_equal(out[:64][need], want[need]), (s, need_lo)
            assert out[64] == (not inside[need].all()), (s, need_lo)
            shim.span_bytes(buf[r0:].ctypes.data, length, s, need_lo, need_hi,
                            0, _ptr(out))
            ok = inside.copy()
            ok[:need_lo] = ok[need_hi:] = False
            assert np.array_equal(out[:64][ok], want[ok]), (s, need_lo)


def test_cuda_wrapper_refuses_cpu_tensors_and_dispatch_stays_plain(monkeypatch):
    """``match_run_cuda`` raises on CPU tensors and on a negative window;
    ``match_run`` on CPU tensors runs the plain version and never reaches
    the kernel library."""
    rng = np.random.default_rng(3)
    a, b = _rows(rng, 4, 64)
    ia, ib, limit = _args(rng, 4, 12, 48, 64)
    args = [torch.from_numpy(x) for x in (a, ia, b, ib, limit)]
    with pytest.raises(ValueError, match="CUDA"):
        tcu.match_run_cuda(*args, 48, True)
    with pytest.raises(ValueError, match="window"):
        tcu.match_run_cuda(*args, -1, True)

    def no_lib():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_cuda, "get_lib", no_lib)
    got = tcu.match_run(*args, 48, True)
    assert torch.equal(got, tcu.match_run_plain(*args, 48, True))
