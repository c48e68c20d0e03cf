"""PyTorch port: the batched data-parallel liftover (gather form) bit-equal
to JAX's ``_liftover_parallel_single`` (mm=False), including items that
overflow the update grid and items whose packed ref2 end overflows."""

import jax
import numpy as np
import pytest
import torch

from portello_tpu.kernels.liftover_parallel import _liftover_parallel_single
from portello_tpu.models.batch import BucketConfig, build_liftover_batch
from portello_tpu.ops import cigar as cg
from portello_tpu.ops.blockmap import build_block_map
from portello_tpu_torch.kernels.liftover_parallel import liftover_batch
from tests.test_liftover_kernel import random_cigar

CFG = BucketConfig(max_ops=48, max_blocks=24, max_seq=2048)


def _items(seed, n=40):
    rng = np.random.default_rng(seed)
    items = []
    while len(items) < n:
        map_cigar = random_cigar(rng, 16)
        map_pos = int(rng.integers(0, 3000))
        bm = build_block_map(map_pos, map_cigar, False)
        if len(bm) > CFG.max_blocks:
            continue
        read_cigar = random_cigar(rng, 40)
        items.append((read_cigar, int(rng.integers(0, 2000)), bm))
    # a map gap wider than 2^17 on ref2: the packed previous-end overflows
    wide = build_block_map(100, cg.from_string("30M200000D30M"), False)
    items.append((cg.from_string("40M"), 10, wide))
    # empty cigar and a read before the first map key
    items.append((np.zeros((0, 2), np.int64), 10, build_block_map(0, cg.from_string("40M"), False)))
    items.append((cg.from_string("5S20M3I20M"), 0, build_block_map(50, cg.from_string("10S40M"), False)))
    return items


@pytest.mark.parametrize("max_rows", [None, CFG.max_ops + CFG.max_blocks, 24])
def test_liftover_matches_jax(max_rows):
    arrays = build_liftover_batch(_items(7 + (max_rows or 0)), CFG)
    want = jax.vmap(
        lambda o, l, n, p, k, v, m: _liftover_parallel_single(
            o, l, n, p, k, v, m, False, max_rows
        )
    )(*arrays)
    got = liftover_batch(*[torch.from_numpy(a) for a in arrays], max_rows)
    names = ("emit_codes", "emit_lens", "ref2_start", "row_overflow")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    ovf = got[3].numpy()
    assert ovf[-3]  # the wide-gap item
    if max_rows == 24:
        assert ovf[:-3].sum() > 5  # spilled rows
    else:
        assert not ovf[:-3].any()
