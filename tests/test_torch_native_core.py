"""The port's ctypes binding of the exact C++ core (``ops/native_core.py``,
built from the port's own ``io/native/ptcore.cc`` into its ``_build/``)
equals the JAX package's binding and the numpy oracle, on the inputs of
``tests/test_native_core.py``, in both of its batch entries."""

import os

import numpy as np
import pytest

from portello_tpu.ops import native_core as jax_core
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.ops import native_core as port_core
from portello_tpu_torch.ops.shift import left_shift_indels
from portello_tpu_torch.testutil import spill
from portello_tpu_torch.testutil.batchgen import make_item_arrays, shift_win_base

BCFG = BucketConfig(max_ops=128, max_blocks=64, max_seq=4096, max_clusters=64,
                    window=24)
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "portello_tpu_torch")


def _batch(b=48, seed=5, rev=False):
    return make_item_arrays(np.random.default_rng(seed), b, BCFG,
                            read_len=3000, read_error=0.01,
                            contig_var_rate=0.004, rev=rev)


def _equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_builds_into_the_port():
    assert port_core.get_lib() is not None, port_core.build_error()
    assert os.path.realpath(port_core._SO) == os.path.join(
        os.path.realpath(PORT), "_build", "native", "ptcore.so")
    assert os.path.exists(port_core._SO)
    assert port_core.hw_threads() >= 1


@pytest.mark.parametrize("n_threads", [1, 4])
def test_lift_simplify_equals_jax_and_oracle(n_threads):
    args = _batch()
    max_out = BCFG.resolved_max_out()
    got = port_core.lift_simplify_batch(*args, max_out, n_threads=n_threads)
    _equal(got, jax_core.lift_simplify_batch(*args, max_out,
                                             n_threads=n_threads))
    codes, lens, n, pos = got
    n_mapped = 0
    for i in range(len(n)):
        want = spill.expect_fwd(args, i)
        if want is None:
            assert n[i] == -1, i
            continue
        n_mapped += 1
        assert pos[i] == want[0] and n[i] == len(want[1]), i
        assert np.array_equal(np.stack([codes[i, :n[i]], lens[i, :n[i]]], 1),
                              want[1].astype(np.int32)), i
    assert n_mapped > 0


def test_unmapped_item():
    args = list(_batch(b=4))
    args[5] = args[5].copy()
    args[5][0, :] = -1          # an all-gap block map: unmapped
    got = port_core.lift_simplify_batch(*args, BCFG.resolved_max_out())
    assert got[2][0] == -1 and got[3][0] == -1
    _equal(got, jax_core.lift_simplify_batch(*args, BCFG.resolved_max_out()))


def test_shift_batch_equals_jax_and_oracle():
    (ops, lens, n_ops, pos, win_base, contig_win, _bk, _bv, _nb,
     _rw, _rb, read_seq) = _batch(seed=7, rev=True)
    rel = pos - win_base
    max_out = BCFG.max_ops + 8
    got = port_core.shift_batch(ops, lens, n_ops, rel, contig_win, read_seq,
                                max_out, n_threads=3)
    _equal(got, jax_core.shift_batch(ops, lens, n_ops, rel, contig_win,
                                     read_seq, max_out, n_threads=3))
    codes, olens, n, opos = got
    for i in range(len(n_ops)):
        cig = np.stack([ops[i, :n_ops[i]], lens[i, :n_ops[i]]], 1).astype(np.int64)
        wp, wc = left_shift_indels(int(rel[i]), cig, contig_win[i], read_seq[i])
        assert n[i] == len(wc) and opos[i] == wp, i
        assert np.array_equal(np.stack([codes[i, :n[i]], olens[i, :n[i]]], 1),
                              wc.astype(np.int32)), i


def test_native_expect_of_a_reverse_batch_equals_the_oracle():
    """``testutil/spill.native_expect`` chains the two entries for a
    ``rev_batch`` batch (shift, then lift + simplify at the window base)."""
    arrays, moved = shift_win_base(_batch(b=16, seed=9, rev=True),
                                   np.random.default_rng(3))
    assert moved.any()
    codes, lens, n, pos = spill.native_expect(arrays, BCFG.resolved_max_out(),
                                              rev=True)
    for i in range(len(n)):
        want = spill.expect_rev(arrays, i)
        if want is None:
            assert n[i] == -1, i
            continue
        assert pos[i] == want[0] and n[i] == len(want[1]), i
        assert np.array_equal(np.stack([codes[i, :n[i]], lens[i, :n[i]]], 1),
                              want[1].astype(np.int32)), i
