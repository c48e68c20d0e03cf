"""PyTorch port, stage 4 of the resident step: the window-runs kernel's
plain versions against the Pallas ``window_match_runs_batch`` kernel in
interpret mode and a per-window numpy reference, and the kernel's shared
per-window compare (``csrc/window_runs.h``) built with g++ and held against
the plain versions.  (The CUDA kernel itself runs only on a GPU:
``chip_smoke.py`` checks it there.)"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portello_tpu.kernels.pallas import window_match as jwm
from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels import window_match as twm
from portello_tpu_torch.kernels.resident import SEQ_SYMBOLS, pack_seq_rows

W = 48
ACGT = np.frombuffer(b"ACGT", np.uint8)


# ------------------------------------------------------------ Pallas contract
def _pallas_inputs(seed=31, length=4096, c=16, b=16):
    """The inputs of tests/test_pallas_window_match.py."""
    rng = np.random.default_rng(seed)
    seq_a = np.empty((b, length), np.uint8)
    seq_b = np.empty((b, length), np.uint8)
    ia = np.empty((b, c), np.int32)
    ib = np.empty((b, c), np.int32)
    for i in range(b):
        a = np.tile(rng.integers(65, 69, size=length // 8, dtype=np.uint8), 8)
        bb = a.copy()
        bb[rng.integers(0, length, 80)] = rng.integers(65, 69, size=80,
                                                       dtype=np.uint8)
        seq_a[i], seq_b[i] = a, bb
        ia[i] = np.sort(rng.integers(-W, length, size=c)).astype(np.int32)
        ib[i] = np.clip(ia[i] + rng.integers(-4, 5, size=c), -W, length)
    return seq_a, seq_b, ia, ib


def test_pad_table_equals_jax():
    rng = np.random.default_rng(1)
    for length in (1, 128, 300):
        seq = rng.integers(0, 256, size=(3, length), dtype=np.uint8)
        got = twm.pad_table(torch.from_numpy(seq), 0xFE)
        for i in range(3):
            want = np.asarray(jwm.pad_table(jnp.asarray(seq[i]), 0xFE))
            assert got.shape[1:] == want.shape
            assert np.array_equal(got[i].numpy(), want)


def test_window_match_plain_equals_pallas_interpret():
    seq_a, seq_b, ia, ib = _pallas_inputs()
    at = np.stack([np.asarray(jwm.pad_table(jnp.asarray(s), 0xFE)) for s in seq_a])
    bt = np.stack([np.asarray(jwm.pad_table(jnp.asarray(s), 0xFD)) for s in seq_b])
    want_f, want_r = jwm.window_match_runs_batch(
        jnp.asarray(at), jnp.asarray(bt), jnp.asarray(ia), jnp.asarray(ib),
        window=W, interpret=True,
    )
    ta = twm.pad_table(torch.from_numpy(seq_a), 0xFE)
    tb = twm.pad_table(torch.from_numpy(seq_b), 0xFD)
    assert np.array_equal(ta.numpy(), at) and np.array_equal(tb.numpy(), bt)
    got_f, got_r = twm.window_match_runs_batch(
        ta, tb, torch.from_numpy(ia), torch.from_numpy(ib), window=W
    )
    assert got_f.dtype == torch.int32 and got_r.dtype == torch.int32
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert 0 < int(got_f.sum()) and int((got_f == W).sum()) > 0


# ---------------------------------------------------------- resident contract
def _decode(packed_row, p):
    k = p >> 1
    byte = int(packed_row[k]) if 0 <= k < len(packed_row) else 0xFD
    return SEQ_SYMBOLS[byte & 15 if p & 1 else byte >> 4]


def _resident_reference(genome, g_base, packed, bs, rs, dl, il, mixed, w):
    """Per-window loops in numpy for the resident contract."""
    nsb = len(genome) // 64

    def gbyte(q, t):
        sb = min(max(q >> 6, 0), nsb - 2)
        return int(genome[(sb << 6) + (q & 63) + t])

    b, c = bs.shape
    raw_r = np.zeros((b, c), np.int32)
    raw_l = np.zeros((b, c), np.int32)
    for i in range(b):
        for j in range(c):
            if not mixed[i, j]:
                continue
            qa = int(g_base[i]) + int(bs[i, j]) + int(dl[i, j]) - w
            pb = int(rs[i, j]) + int(il[i, j]) - w
            eq = [gbyte(qa, t) == _decode(packed[i], pb + t) for t in range(w)]
            raw_r[i, j] = (eq[::-1] + [False]).index(False)
            qa = int(g_base[i]) + int(bs[i, j])
            eq = [gbyte(qa, t) == _decode(packed[i], int(rs[i, j]) + t)
                  for t in range(w)]
            raw_l[i, j] = (eq + [False]).index(False)
    return raw_r, raw_l


def _resident_case(seed, n_genome=1536, b=12, c=16, max_seq=512):
    """A genome, packed reads copied from it with mutations, and clusters
    over the whole contract domain: window starts at -W and at the row's
    end, odd read offsets, windows off both ends of the genome."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(ACGT, size=n_genome)
    g_base = rng.integers(0, n_genome - 200, size=b).astype(np.int64)
    g_base[0], g_base[1] = 0, n_genome - 150
    rows = np.zeros((b, max_seq), np.uint8)
    for i in range(b):
        seg = genome[g_base[i]:g_base[i] + max_seq - 20]
        rows[i, :len(seg)] = seg
        mut = rng.random(len(seg)) < 0.02
        rows[i, :len(seg)][mut] = rng.choice(ACGT, size=int(mut.sum()))
    packed = pack_seq_rows(rows)
    bs = rng.integers(0, max_seq, size=(b, c)).astype(np.int32)
    rs = np.where(rng.random((b, c)) < 0.7, bs,
                  bs + rng.integers(-3, 4, size=(b, c))).astype(np.int32)
    dl = rng.integers(1, 60, size=(b, c)).astype(np.int32)
    il = rng.integers(1, 60, size=(b, c)).astype(np.int32)
    bs[:, 0], rs[:, 0], dl[:, 0], il[:, 0] = 0, 0, 0, 0   # right start -W
    bs[:, 1], rs[:, 1] = max_seq, max_seq                  # left start = len
    rs[:, 2] = bs[:, 2] | 1                                # odd parity
    rs[:, 3] = -W                                          # before the row
    mixed = rng.random((b, c)) < 0.6
    mixed[:, :4] = True
    return genome, g_base, packed, bs, rs, dl, il, mixed


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_resident_plain_equals_reference(seed):
    genome, g_base, packed, bs, rs, dl, il, mixed = _resident_case(seed)
    got = twm.window_runs_resident(*_torch(genome, g_base, packed, bs, rs, dl,
                                           il, mixed), W)
    want = _resident_reference(genome, g_base, packed, bs, rs, dl, il, mixed, W)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
    assert int((got[1] == W).sum()) > 0 and int((got[0] == 0).sum()) > 0
    assert not got[0].numpy()[~mixed].any() and not got[1].numpy()[~mixed].any()


# --------------------------------------------------- the header built with g++
SHIM = r"""
#include "window_runs.h"

namespace {
// Bytes [base, base + n) of a larger index space: a genome whose offsets
// pass 2^31 without allocating it.
struct SparseLoad {
  const uint8_t* p;
  int64_t base;
  int operator()(int64_t i) const { return p[i - base]; }
};
}  // namespace

extern "C" void resident_runs(const uint8_t* genome, int64_t genome_base,
                              int64_t genome_len, const int64_t* g_base,
                              const uint8_t* packed, int lp, const int32_t* bs,
                              const int32_t* rs, const int32_t* dl,
                              const int32_t* il, const uint8_t* mixed, int b,
                              int c, int window, int32_t* raw_r,
                              int32_t* raw_l) {
  for (int64_t k = 0; k < int64_t(b) * c; ++k) {
    const int64_t item = k / c;
    raw_r[k] = raw_l[k] = 0;
    if (!mixed[k]) continue;
    ptt::resident_cluster_runs(SparseLoad{genome, genome_base}, genome_len / 64,
                               g_base[item], ptt::DirectLoad{packed + item * lp},
                               lp, bs[k], rs[k], dl[k], il[k], window,
                               &raw_r[k], &raw_l[k]);
  }
}

extern "C" void table_runs(const uint8_t* a, const uint8_t* b_tab, int nsb,
                           const int32_t* ia, const int32_t* ib, int b, int c,
                           int window, int32_t* fwd, int32_t* rev) {
  for (int64_t k = 0; k < int64_t(b) * c; ++k) {
    const int64_t row = (k / c) * int64_t(nsb) * 128;
    ptt::table_cluster_runs(ptt::DirectLoad{a + row}, ptt::DirectLoad{b_tab + row},
                            nsb, ia[k], ib[k], window, &fwd[k], &rev[k]);
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("window_runs")
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
    lib.resident_runs.argtypes = [vp, ll, ll, vp, vp, i, vp, vp, vp, vp, vp,
                                  i, i, i, vp, vp]
    lib.table_runs.argtypes = [vp, vp, i, vp, vp, i, i, i, vp, vp]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _shim_resident(lib, genome, genome_base, genome_len, g_base, packed, bs,
                   rs, dl, il, mixed):
    b, c = bs.shape
    raw_r = np.full((b, c), -1, np.int32)
    raw_l = np.full((b, c), -1, np.int32)
    g_base = np.ascontiguousarray(g_base, np.int64)
    mixed = np.ascontiguousarray(mixed, np.uint8)
    lib.resident_runs(_ptr(genome), genome_base, genome_len, _ptr(g_base),
                      _ptr(packed), packed.shape[1], _ptr(bs), _ptr(rs),
                      _ptr(dl), _ptr(il), _ptr(mixed), b, c, W, _ptr(raw_r),
                      _ptr(raw_l))
    return raw_r, raw_l


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_header_resident_equals_plain(shim, seed):
    genome, g_base, packed, bs, rs, dl, il, mixed = _resident_case(seed)
    got = _shim_resident(shim, genome, 0, len(genome), g_base, packed, bs, rs,
                         dl, il, mixed)
    want = twm.window_runs_resident_plain(
        *_torch(genome, g_base, packed, bs, rs, dl, il, mixed), W
    )
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


def test_header_resident_offsets_above_2_31(shim):
    """The genome is the tail of a 4.3 GB index space: only its last 1536
    bytes exist.  The header reads it at offsets past 2^32 (the tail clamp
    included); the plain version reads the same bytes at offsets shifted
    down by the 64-aligned base, so the two must agree."""
    genome, g_base, packed, bs, rs, dl, il, mixed = _resident_case(7)
    shift = (2**32 // 64 + 12_345) * 64
    assert shift > 2**31 and shift % 64 == 0
    got = _shim_resident(shim, genome, shift, shift + len(genome),
                         g_base + shift, packed, bs, rs, dl, il, mixed)
    want = twm.window_runs_resident_plain(
        *_torch(genome, g_base, packed, bs, rs, dl, il, mixed), W
    )
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert (got[0][mixed] > 0).any() and (got[1][mixed] > 0).any()


def test_header_table_equals_plain(shim):
    seq_a, seq_b, ia, ib = _pallas_inputs(seed=32, length=1000, c=24, b=8)
    ia[:, 0], ib[:, 0] = -W, -W
    ia[:, 1], ib[:, 1] = 1000, 1000
    ia[:, 2] = ib[:, 2] = 999
    ta = twm.pad_table(torch.from_numpy(seq_a), 0xFE).contiguous()
    tb = twm.pad_table(torch.from_numpy(seq_b), 0xFD).contiguous()
    b, nsb, _ = ta.shape
    fwd = np.full(ia.shape, -1, np.int32)
    rev = np.full(ia.shape, -1, np.int32)
    an, bn = ta.numpy(), tb.numpy()
    shim.table_runs(_ptr(an), _ptr(bn), nsb, _ptr(ia), _ptr(ib), b,
                    ia.shape[1], W, _ptr(fwd), _ptr(rev))
    want_f, want_r = twm.window_match_runs_plain(
        ta, tb, torch.from_numpy(ia), torch.from_numpy(ib), W
    )
    assert np.array_equal(fwd, want_f.numpy())
    assert np.array_equal(rev, want_r.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    g = torch.zeros(256, dtype=torch.uint8)
    s = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        twm.window_runs_resident_cuda(
            g, torch.zeros(2, dtype=torch.int64),
            torch.zeros((2, 8), dtype=torch.uint8), s, s, s, s,
            torch.zeros((2, 3), dtype=torch.bool), W,
        )
    t = torch.zeros((2, 4, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        twm.window_match_runs_cuda(t, t, s, s, W)

