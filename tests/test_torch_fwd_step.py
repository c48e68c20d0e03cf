"""PyTorch port: the whole forward step bit-equal to JAX's
``pipeline_model.fwd_batch(mm=False)``, and the state both packages share
(bucket table, synthetic batches) equal field for field."""

import dataclasses

import numpy as np
import pytest
import torch

from portello_tpu.models import pipeline_model as jpm
from portello_tpu.models.batch import BucketConfig as JaxBucketConfig
from portello_tpu.testutil import batchgen as jbg
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.testutil import batchgen as tbg

SMALL = dict(max_ops=32, max_blocks=16, max_seq=2048, max_clusters=24, window=48)


def test_default_buckets_equal_field_by_field():
    assert len(tpm.DEFAULT_BUCKETS) == len(jpm.DEFAULT_BUCKETS)
    for t, j in zip(tpm.DEFAULT_BUCKETS, jpm.DEFAULT_BUCKETS):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.resolved_max_out() == j.resolved_max_out()
        assert t.resolved_max_rows() == j.resolved_max_rows()
    assert [f.name for f in dataclasses.fields(BucketConfig)] == [
        f.name for f in dataclasses.fields(JaxBucketConfig)
    ]
    assert dataclasses.asdict(tbg.HIFI_BUCKET) == dataclasses.asdict(jbg.HIFI_BUCKET)


def test_make_item_arrays_equals_jax_helper():
    kw = dict(read_len=1500, read_error=0.01, contig_var_rate=0.01)
    got = tbg.make_item_arrays(
        np.random.default_rng(5), 12, BucketConfig(**SMALL), **kw
    )
    want = jbg.make_item_arrays(
        np.random.default_rng(5), 12, JaxBucketConfig(**SMALL), **kw
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize(
    "seed,rates",
    [(3, (0.0025, 0.0012)), (4, (0.02, 0.01))],
)
def test_fwd_batch_matches_jax(seed, rates):
    bcfg = BucketConfig(**SMALL)
    read_error, var_rate = rates
    arrays = tbg.make_item_arrays(
        np.random.default_rng(seed), 48, bcfg, read_len=1500,
        read_error=read_error, contig_var_rate=var_rate,
    )
    kw = tpm.bucket_kwargs(bcfg)
    want = jpm.fwd_batch(*arrays, mm=False, **kw)
    got = tpm.fwd_batch(*tpm.batch_from_numpy(arrays, "cpu"), **kw)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        assert np.array_equal(got[key].numpy(), w), key
    assert got["mapped"].any()


def test_batch_from_numpy_checks_inputs():
    arrays = tbg.make_item_arrays(
        np.random.default_rng(1), 2, BucketConfig(**SMALL), read_len=500
    )
    t = tpm.batch_from_numpy(arrays, "cpu")
    assert [x.dtype for x in t] == [d for _, d in tpm.FWD_FIELDS]
    with pytest.raises(ValueError):
        tpm.batch_from_numpy(arrays[:-1], "cpu")
    bad = list(arrays)
    bad[0] = bad[0].astype(np.int64)
    with pytest.raises(ValueError, match="ops"):
        tpm.batch_from_numpy(bad, "cpu")
    assert isinstance(t[0], torch.Tensor)
