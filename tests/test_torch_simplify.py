"""PyTorch port: indel simplification (gather form) bit-equal to JAX's
``simplify_batch`` with mm=False (``_simplify_single``'s gather branch),
on cigars dense in pure, 1/1 and mixed I/D clusters with homologous and
random inserted bases."""

import numpy as np
import pytest
import torch

from portello_tpu.kernels.simplify_kernel import simplify_batch as jax_simplify
from portello_tpu_torch.kernels.simplify_kernel import simplify_batch

MAX_SEQ = 2048
K = 96


def _batch(seed, b=32):
    rng = np.random.default_rng(seed)
    codes = np.full((b, K), 9, np.int32)
    lens = np.zeros((b, K), np.int32)
    ref_pos = np.zeros(b, np.int32)
    ref_win = np.zeros((b, MAX_SEQ), np.uint8)
    read_seq = np.zeros((b, MAX_SEQ), np.uint8)
    for i in range(b):
        ref = rng.integers(65, 69, size=1700, dtype=np.uint8)
        ref_win[i, : len(ref)] = ref
        rp = int(rng.integers(0, 30))
        ref_pos[i] = rp
        ops, read = [], []
        if rng.random() < 0.3:
            ops.append((4, 5))
            read.extend(rng.integers(65, 69, size=5))
        n_target = int(rng.integers(4, K // 2 - 2))
        while len(ops) < n_target and rp < 1400:
            m = int(rng.integers(3, 30))
            ops.append((int(rng.choice([0, 7, 8])), m))
            read.extend(ref[rp : rp + m])
            rp += m
            kind = rng.integers(0, 5)
            big = rng.random() < 0.2
            d = int(rng.integers(20, 70)) if big else int(rng.integers(1, 6))
            ins_n = int(rng.integers(20, 70)) if big else int(rng.integers(1, 6))
            if kind == 0:
                ops.append((2, d))
                rp += d
            elif kind == 1:
                ops.append((1, ins_n))
                read.extend(rng.integers(65, 69, size=ins_n))
            elif kind == 2:
                ops.extend([(1, 1), (2, 1)])
                read.append(int(rng.integers(65, 69)))
                rp += 1
            else:
                # mixed: the inserted bases often repeat the deleted ones
                # (long common runs, saturating windows)
                deleted = ref[rp : rp + d]
                if rng.random() < 0.6:
                    ins = np.resize(deleted, ins_n)
                else:
                    ins = rng.integers(65, 69, size=ins_n, dtype=np.uint8)
                pair = [(2, d), (1, ins_n)]
                if rng.random() < 0.5:
                    pair.reverse()
                ops.extend(pair)
                rp += d
                read.extend(ins)
        ops.append((0, int(rng.integers(5, 30))))
        read.extend(ref[rp : rp + ops[-1][1]])
        n = len(ops)
        codes[i, :n] = [c for c, _ in ops]
        lens[i, :n] = [x for _, x in ops]
        read_seq[i, : len(read)] = read
    return codes, lens, ref_pos, ref_win, read_seq


@pytest.mark.parametrize(
    "max_clusters,window,max_out",
    [(48, 16, 96), (48, 48, 96), (8, 16, 40)],
)
def test_simplify_matches_jax(max_clusters, window, max_out):
    arrays = _batch(window + max_clusters + max_out)
    kw = dict(max_clusters=max_clusters, window=window, max_out=max_out)
    want = jax_simplify(*arrays, mm=False, **kw)
    got = simplify_batch(*map(torch.from_numpy, arrays), **kw)
    names = ("codes", "lens", "n_out", "ref_pos", "fallback")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    fb = got[4].numpy()
    # some items fall back (saturated windows, cluster or output overflow),
    # most do not
    assert 0 < fb.sum() < len(fb)
