"""The spill path's steps on the CPU: the port's ``fwd_batch``,
``fwd_batch_resident`` and ``rev_batch`` in the mid and wide buckets
(``DEFAULT_BUCKETS[1]`` and ``[2]``, at their full widths, on a few items)
bit-equal to the JAX package's ``fwd_batch(mm=False)``,
``fwd_batch_resident`` and ``rev_batch(mm=False)``, and to the exact C++
core; and the hostile-rate fuzz of ``testutil/spill.py`` (the port of
``tests/test_fuzz_conformance.py``) on pinned seeds, with its
cluster-overflow item.  All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from portello_tpu.models import pipeline_model as jpm
from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.testutil import spill
from portello_tpu_torch.testutil.batchgen import shift_win_base

FIELDS = ("codes", "lens", "n_out", "ref2_pos", "mapped", "read_len",
          "fallback")


@pytest.fixture(scope="module", params=[1, 2], ids=["mid", "wide"])
def bucket(request):
    """(bucket index, reverse batch with half its items at moved window
    bases, forward batch) of 3 items shaped for the bucket."""
    bi = request.param
    rev, moved = shift_win_base(spill.spill_batch(80 + bi, 3, bi, chunk=3),
                                np.random.default_rng(bi))
    assert moved.any()
    return bi, rev, spill.fwd_of_rev(spill.spill_batch(90 + bi, 3, bi, chunk=3))


def _equal(got, want, keep=None):
    assert set(got) == set(FIELDS)
    for key in FIELDS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        if keep is not None:
            g, w = g[keep], w[keep]
        assert np.array_equal(g, w), key


def _native(out, args, kw, rev=False):
    counters = spill.new_counters()
    spill.check_native(out, args, kw["max_out"], counters, rev=rev)
    assert counters["exact"] > 0, counters
    return counters


@pytest.mark.parametrize("step", ["fwd", "resident", "rev"])
def test_spill_step_equals_jax(bucket, step):
    bi, rev_args, fwd_args = bucket
    kw = tpm.bucket_kwargs(tpm.DEFAULT_BUCKETS[bi])
    ops = (rev_args if step == "rev" else fwd_args)[2]
    lo = tpm.DEFAULT_BUCKETS[bi - 1].max_ops
    assert (ops > lo).any(), ops     # the items do not fit the bucket below
    if step == "rev":
        got = tpm.rev_batch(*tpm.rev_batch_from_numpy(rev_args, "cpu"), **kw)
        _equal(got, jpm.rev_batch(*rev_args, mm=False, **kw))
        _native(got, rev_args, kw, rev=True)
        return
    table = jpm.fwd_batch(*fwd_args, mm=False, **kw)
    if step == "fwd":
        got = tpm.fwd_batch(*tpm.batch_from_numpy(fwd_args, "cpu"), **kw)
        _equal(got, table)
        _native(got, fwd_args, kw)
        return
    res_args, genome = spill._resident_args(fwd_args)
    got = tpm.fwd_batch_resident(*tpm.resident_batch_from_numpy(res_args, "cpu"),
                                 genome_tensor(genome, "cpu"), **kw)
    _equal(got, table)
    # JAX's resident step (one-hot form) has a mixed-cluster budget of its
    # own: equal on the items it does not flag, the port flags a subset
    want = jpm.fwd_batch_resident(
        *res_args, jnp.asarray(genome.view(np.uint32).reshape(-1, 16)), **kw)
    jfb = np.asarray(want["fallback"])
    assert not (got["fallback"].numpy() & ~jfb).any()
    _equal(got, want, keep=~jfb)


@pytest.mark.parametrize("case", [0, 1, 2, 3, "cluster_overflow"])
def test_hostile_fuzz(case):
    """Every item the port's steps do not flag equals the numpy oracle and
    the C++ core; seed 3 flags items, and the cluster-overflow item must
    flag while the items beside it stay exact."""
    if case == "cluster_overflow":
        args = spill.cluster_overflow_batch()
        out = tpm.fwd_batch(*tpm.batch_from_numpy(args, "cpu"), **spill.KW)
        assert bool(out["fallback"][0])
        counters = spill.new_counters()
        spill.check_batch(out, args, spill.expect_fwd, counters)
        spill.check_native(out, args, spill.KW["max_out"], spill.new_counters())
        assert counters["exact"] > 0 and counters["fallback"] > 0, counters
        return
    counters = spill.hostile_rounds(case, "cpu")
    assert counters["exact"] > 0, counters
    if case == 3:
        assert counters["fallback"] > 0, counters


def test_a_mismatch_names_the_item_and_field():
    args = spill.cluster_overflow_batch()
    out = tpm.fwd_batch(*tpm.batch_from_numpy(args, "cpu"), **spill.KW)
    out["ref2_pos"][5] += 1
    with pytest.raises(spill.Mismatch, match="item 5 field ref2_pos"):
        spill.check_native(out, args, spill.KW["max_out"], spill.new_counters())
    with pytest.raises(spill.Mismatch, match="item 5 field ref2_pos"):
        spill.check_batch(out, args, spill.expect_fwd, spill.new_counters())
