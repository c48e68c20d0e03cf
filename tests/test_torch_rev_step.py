"""PyTorch port: the reverse step ``rev_batch`` bit-equal to the JAX
package's three layouts of it (``rev_batch(mm=False)``, ``rev_batch_fused``,
``rev_chain_batch``) on the CPU, at window base 0 and at nonzero window
bases; one HiFi-bucket case against the oracle chain; and the port's
reverse batches of ``make_item_arrays`` equal to the JAX helper's."""

import numpy as np
import pytest

from portello_tpu.models import pipeline_model as jpm
from portello_tpu.models.batch import BucketConfig as JaxBucketConfig
from portello_tpu.ops.blockmap import BlockMap
from portello_tpu.ops.liftover import liftover_read_alignment
from portello_tpu.ops.shift import left_shift_indels
from portello_tpu.ops.simplify import simplify_alignment_indels
from portello_tpu.testutil import batchgen as jbg
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.testutil import batchgen as tbg

SMALL = dict(max_ops=32, max_blocks=16, max_seq=512, max_clusters=24, window=48)


def _batch(seed, b=24, moved=False, read_len=400, rates=(0.02, 0.01)):
    rng = np.random.default_rng(seed)
    arrays = tbg.make_item_arrays(
        rng, b, BucketConfig(**SMALL), read_len=read_len,
        read_error=rates[0], contig_var_rate=rates[1], rev=True,
    )
    if moved:
        arrays, mask = tbg.shift_win_base(arrays, rng)
        assert mask.any() and not mask.all()
    return arrays


def _port(arrays, bcfg):
    out = tpm.rev_batch(*tpm.rev_batch_from_numpy(arrays, "cpu"),
                        **tpm.bucket_kwargs(bcfg))
    return {k: v.numpy() for k, v in out.items()}


def _assert_fields(got, want, keep=None):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype, key
        if keep is None:
            assert np.array_equal(got[key], w), key
        else:
            assert np.array_equal(got[key][keep], w[keep]), key


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_rev_batch_matches_jax_layouts(seed, moved):
    bcfg = BucketConfig(**SMALL)
    arrays = _batch(seed, moved=moved)
    got = _port(arrays, bcfg)
    kw = tpm.bucket_kwargs(bcfg)
    # the staged and the per-item layouts of the gather form: every field
    _assert_fields(got, jpm.rev_batch(*arrays, mm=False, **kw))
    _assert_fields(got, jpm.rev_batch_fused(*arrays, mm=False, **kw))
    # the fused mm chain has compaction budgets of its own: equal on the
    # items neither side flags, and the port flags a subset of its items
    want = jpm.rev_chain_batch(*arrays, mm=True, **kw)
    fb_w = np.asarray(want["fallback"])
    assert not (got["fallback"] & ~fb_w).any()
    keep = ~got["fallback"] & ~fb_w
    assert keep.sum() > len(keep) // 2
    _assert_fields(got, want, keep)
    assert got["mapped"].any()


def test_rev_batch_nonzero_win_base_equals_base_zero():
    """Moving an item deeper into a longer contig (window base, position
    and block keys by the same prefix) leaves its output unchanged."""
    bcfg = BucketConfig(**SMALL)
    base0 = _batch(3)
    moved, mask = tbg.shift_win_base(base0, np.random.default_rng(30))
    a, b = _port(base0, bcfg), _port(moved, bcfg)
    keep = ~a["fallback"] & ~b["fallback"]
    assert keep[mask].sum() > 0
    for key in a:
        assert np.array_equal(a[key][keep], b[key][keep]), key


def _edge_batch(max_ops, max_blocks, max_seq):
    """Two reverse items at the bucket's edge (n_ops == max_ops): match runs
    split by 1-base N ops, then ``6M 2D`` whose deletion has 2 bases of
    homology.  The left shift turns ``6M 2D`` into ``4M 2D 2M``, so item 0's
    shifted cigar has max_ops + 1 runs; item 1 ends in ``6M 2N`` and keeps
    max_ops runs."""
    from portello_tpu.ops import cigar as cg

    b = 2
    ops = np.full((b, max_ops), tpm.PAD, np.int32)
    lens = np.zeros((b, max_ops), np.int32)
    body = [(cg.M, 3) if j % 2 == 0 else (cg.N, 1) for j in range(max_ops - 2)]
    tails = ([(cg.M, 6), (cg.D, 2)], [(cg.M, 6), (cg.N, 2)])
    contig = np.frombuffer(b"ACGT" * (max_seq // 4), np.uint8).copy()
    read_seq = np.zeros((b, max_seq), np.uint8)
    for i, tail in enumerate(tails):
        cig = np.array(body + tail, np.int32)
        ops[i], lens[i] = cig[:, 0], cig[:, 1]
        ref_end = int(cig[:, 1].sum())
        # the deleted bases and the two before them: homology 2, not more
        contig[ref_end - 4:ref_end] = ord("A")
        rp, parts = 0, []
        for code, ln in cig:
            if code == cg.M:
                parts.append(contig[rp:rp + ln])
            rp += ln
        rs = np.concatenate(parts)
        read_seq[i, :len(rs)] = rs
    contig_win = np.tile(contig, (b, 1))
    n_ops = np.full(b, max_ops, np.int32)
    zero = np.zeros(b, np.int32)
    bk = np.full((b, max_blocks), tpm.INT32_MAX, np.int32)
    bv = np.full((b, max_blocks), -1, np.int32)
    bk[:, 0] = bv[:, 0] = 0
    nb = np.ones(b, np.int32)
    return (ops, lens, n_ops, zero, zero.copy(), contig_win, bk, bv, nb,
            contig_win.copy(), zero.copy(), read_seq)


def test_rev_batch_flags_every_overflowing_shift():
    """Every item whose stage-B run count exceeds max_ops falls back, as in
    JAX; the item beside it at the same width does not."""
    from portello_tpu_torch.kernels.cigar_kernels import compress
    from portello_tpu_torch.kernels.shift_kernel import (
        shift_stage_a,
        shift_stage_b_emit,
    )

    bcfg = BucketConfig(**SMALL)
    arrays = _edge_batch(bcfg.max_ops, bcfg.max_blocks, bcfg.max_seq)
    t = tpm.rev_batch_from_numpy(arrays, "cpu")
    st = shift_stage_a(t[0], t[1], t[3] - t[4], t[4], t[5], t[11],
                       max_clusters=bcfg.max_clusters, window=bcfg.window)
    codes, lens, _ = shift_stage_b_emit(t[0], t[1], st, window=bcfg.window)
    runs = compress(codes, lens, codes.shape[1])[2].numpy()
    assert list(runs > bcfg.max_ops) == [True, False]
    got = _port(arrays, bcfg)
    _assert_fields(got, jpm.rev_batch(*arrays, mm=False,
                                      **tpm.bucket_kwargs(bcfg)))
    assert list(got["fallback"]) == [True, False]
    assert got["mapped"][1]


def test_rev_hifi_bucket_matches_oracle_chain():
    """The production HiFi bucket (128/48/24576/96/48) at B=2, 18 kb items:
    unflagged items equal left_shift_indels -> liftover_read_alignment ->
    simplify_alignment_indels, and the step equals JAX's."""
    b = 2
    args = tbg.make_item_arrays(
        np.random.default_rng(20260818), b, tbg.HIFI_BUCKET, read_len=18000,
        rev=True,
    )
    (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
     ref_win, ref_base, read_seq) = args
    got = _port(args, tbg.HIFI_BUCKET)
    _assert_fields(got, jpm.rev_batch(*args, mm=False,
                                      **tpm.bucket_kwargs(tbg.HIFI_BUCKET)))
    fb = got["fallback"]
    assert not fb.all()
    for i in range(b):
        if fb[i]:
            continue
        n = int(n_ops[i])
        cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
        p1, sh = left_shift_indels(int(pos[i]), cig, contig_win[i], read_seq[i])
        k = int(nb[i])
        bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
        p, c = liftover_read_alignment(bm, p1, sh)
        rp, rc = simplify_alignment_indels(
            p - int(ref_base[i]), c, ref_win[i], read_seq[i]
        )
        n_out = int(got["n_out"][i])
        out = np.stack([got["codes"][i, :n_out], got["lens"][i, :n_out]], 1)
        assert int(got["ref2_pos"][i]) == int(ref_base[i]) + rp
        assert np.array_equal(out.astype(np.int64), rc)


def test_make_item_arrays_rev_equals_jax_helper():
    kw = dict(read_len=1500, read_error=0.01, contig_var_rate=0.01, rev=True)
    got = tbg.make_item_arrays(
        np.random.default_rng(6), 8, BucketConfig(**SMALL), **kw
    )
    want = jbg.make_item_arrays(
        np.random.default_rng(6), 8, JaxBucketConfig(**SMALL), **kw
    )
    assert len(got) == len(want) == len(tpm.REV_FIELDS)
    for g, w, (name, dtype) in zip(got, want, tpm.REV_FIELDS):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert [t.dtype for t in tpm.rev_batch_from_numpy(got, "cpu")] == [
        d for _, d in tpm.REV_FIELDS
    ]
