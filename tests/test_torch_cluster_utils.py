"""PyTorch port: cluster detection and the window common run bit-equal to
JAX's gather form and to the Pallas ``match_run_batch_pallas`` kernel in
interpret mode."""

import jax
import numpy as np
import pytest
import torch

from portello_tpu.kernels import cluster_utils as jcu
from portello_tpu.kernels.pallas.match_run_pallas import (
    match_run_batch_pallas,
    pad_for_match_run,
)
from portello_tpu_torch.kernels import cluster_utils as tcu

B, C, W, L = 8, 16, 48, 512


def _cigars(seed, b=24, n=64):
    """Padded random cigars dense in I/D so clusters of every shape occur."""
    rng = np.random.default_rng(seed)
    codes = rng.choice([0, 1, 2, 4, 7, 8], size=(b, n),
                       p=[0.3, 0.25, 0.25, 0.05, 0.1, 0.05]).astype(np.int32)
    lens = rng.integers(0, 40, size=(b, n)).astype(np.int32)
    for i in range(b):
        codes[i, rng.integers(n // 2, n + 1):] = 9
    ref_pos = rng.integers(0, 5000, size=b).astype(np.int32)
    return codes, lens, ref_pos


def test_op_positions_match():
    codes, lens, ref_pos = _cigars(1)
    want = jax.vmap(jcu.op_positions)(codes, lens, ref_pos)
    got = tcu.op_positions(*map(torch.from_numpy, (codes, lens, ref_pos)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_clusters", [4, 24])
def test_find_clusters_matches(max_clusters):
    codes, lens, ref_pos = _cigars(2 + max_clusters)
    want = jax.vmap(
        lambda c, l, p: jcu.find_clusters(c, l, p, max_clusters, False)
    )(codes, lens, ref_pos)
    got = tcu.find_clusters(
        *map(torch.from_numpy, (codes, lens, ref_pos)), max_clusters
    )
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        assert np.array_equal(got[key].numpy(), w), key
    if max_clusters == 4:
        assert got["overflow"].any()


def _seqs(rng):
    a = rng.integers(65, 68, size=(B, L), dtype=np.uint8)
    b = a.copy()
    muts = rng.integers(0, L, size=(B, 40))
    for i in range(B):
        b[i, muts[i]] = 60 + rng.integers(0, 4, size=40).astype(np.uint8)
    a[:, -20:] = 0  # in-row zero padding compares as data
    b[:, -30:] = 0
    b[0] = a[0]  # one row without mismatches, so windows saturate
    return a, b


def _starts(rng, lo, hi):
    ia = rng.integers(lo, hi + 1, size=(B, C)).astype(np.int32)
    ib = np.where(rng.random((B, C)) < 0.7, ia,
                  rng.integers(lo, hi + 1, size=(B, C))).astype(np.int32)
    ia[:, :2], ib[:, :2] = lo, lo      # the ends of the legal domain
    ia[:, 2:4], ib[:, 2:4] = hi, hi
    ib[0] = ia[0]
    return ia, ib


@pytest.mark.parametrize("side", ["left", "right"])
def test_match_run_matches_xla(side):
    rng = np.random.default_rng(3 if side == "left" else 4)
    a, b = _seqs(rng)
    # left: window starts over [-W, L]; right: window ends over [0, L]
    ia, ib = _starts(rng, -W, L) if side == "left" else _starts(rng, 0, L)
    limit = rng.integers(-2, W + 9, size=(B, C)).astype(np.int32)
    limit[0, 4:] = W + 8
    jfn = jcu.match_run_left if side == "left" else jcu.match_run_right
    tfn = tcu.match_run_left if side == "left" else tcu.match_run_right
    want = jax.vmap(lambda aa, x, bb, y, l: jfn(aa, x, bb, y, l, W))(
        a, ia, b, ib, limit
    )
    got = tfn(*map(torch.from_numpy, (a, ia, b, ib, limit)), W)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[0].sum()) and got[1].any()


@pytest.mark.parametrize("rev", [0, 1])
def test_match_run_matches_pallas_interpret(rev):
    rng = np.random.default_rng(10 + rev)
    a, b = _seqs(rng)
    ia, ib = _starts(rng, 0, L) if rev else _starts(rng, -W, L)
    limit = rng.integers(0, W + 9, size=(B, C)).astype(np.int32)
    limit[0, 4:] = W + 8
    want, want_sat = match_run_batch_pallas(
        np.asarray(pad_for_match_run(a, W, 0xFE)),
        np.asarray(pad_for_match_run(b, W, 0xFD)),
        ia + W, ib + W, limit, np.full((B, C), rev, np.int32),
        window=W, interpret=True,
    )
    tfn = tcu.match_run_right if rev else tcu.match_run_left
    got, sat = tfn(*map(torch.from_numpy, (a, ia, b, ib, limit)), W)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(sat.numpy(), np.asarray(want_sat))


def test_out_of_row_reads_are_sentinels():
    """Reads outside [0, L) return 0xFE for a and 0xFD for b: they never
    match, even where both rows hold the same byte value."""
    a = np.full((2, 64), 0xFE, np.uint8)
    b = np.full((2, 64), 0xFE, np.uint8)
    start = np.array([[-3, 60], [0, 64]], np.int32)
    limit = np.full((2, 2), 10, np.int32)
    args = [torch.from_numpy(x) for x in (a, start, b, start, limit)]
    run, _ = tcu.match_run_left(*args, 16)
    # -3: a reads 0xFE (sentinel) vs b 0xFD at t=0; 60: 4 in-row bytes
    assert run.tolist() == [[0, 4], [10, 0]]
    run, _ = tcu.match_run_right(*args, 16)
    assert run.tolist() == [[0, 10], [0, 10]]


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros((2, 8), dtype=torch.uint8)
    s = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tcu.match_run_cuda(a, s, a, s, s, 4, False)
