"""PyTorch port: ``graft_entry``, the counterpart of the root
``__graft_entry__.py``.  ``entry(device="cpu")`` returns the JAX entry's
example batch, and its step computes what the JAX entry's step computes on
it, field for field; ``dryrun_multichip`` passes on four CPU shards and
fails on a sharded step that loses a shard's rows."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from portello_tpu.testutil.batchgen import make_item_arrays
from portello_tpu_torch import graft_entry
from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.models.pipeline_model import resident_batch_from_numpy

CPU = torch.device("cpu")


def test_entry_on_cpu_equals_jax_entry():
    jfn, jargs = jax_entry.entry()
    want = jfn(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    # the JAX entry's arrays carried across by the port's own mapping
    *batch, words = (np.asarray(a) for a in jargs)
    carried = (*resident_batch_from_numpy(batch, CPU), genome_tensor(words, CPU))
    assert len(args) == len(carried)
    for a, c in zip(args, carried):
        assert a.device == CPU and a.dtype == c.dtype and torch.equal(a, c)
    for got in (fn(*args), fn(*carried)):
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype, k
            assert np.array_equal(got[k].numpy(), w), k
    assert bool(got["mapped"].any())


def test_resident_args_copy_equals_jax():
    bcfg = BucketConfig(max_ops=64, max_blocks=16, max_seq=512,
                        max_clusters=24, window=16)
    items = make_item_arrays(np.random.default_rng(7), 6, bcfg, read_len=300)
    got = graft_entry._resident_args_from_table(items)
    want = jax_entry._resident_args_from_table(items)
    for g_part, w_part in zip(got[:2], want[:2]):
        for g, w in zip(g_part, w_part):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2].dtype == want[2].dtype and np.array_equal(got[2], want[2])


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        _, args = graft_entry.entry()
        assert all(a.is_cuda for a in args)
    else:
        # no GPU here: the default device is refused, never the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            graft_entry.entry()


def test_dryrun_multichip_on_cpu_shards():
    graft_entry.dryrun_multichip(4, devices=[CPU] * 4)


def test_dryrun_multichip_needs_the_devices():
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(4, devices=[CPU] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            graft_entry.dryrun_multichip(2)


def _drop_last_shard(make_step):
    """A sharded step maker whose step loses the last shard's rows."""

    def make(mesh, **kw):
        step = make_step(mesh, **kw)

        def run(*arrays):
            out = step(*arrays)
            rows = next(iter(out.values())).shape[0] // len(mesh)
            return {k: v[:-rows] for k, v in out.items()}

        return run

    return make


@pytest.mark.parametrize("maker,what", [
    ("make_sharded_fwd_step", "sharded fwd step"),
    ("make_sharded_fwd_resident_step", "sharded resident fwd step"),
    ("make_sharded_rev_step", "sharded rev step"),
])
def test_dryrun_multichip_catches_a_lost_shard(monkeypatch, maker, what):
    monkeypatch.setattr(graft_entry, maker,
                        _drop_last_shard(getattr(graft_entry, maker)))
    with pytest.raises(AssertionError, match=f"^{what} diverges"):
        graft_entry.dryrun_multichip(4, devices=[CPU] * 4)
