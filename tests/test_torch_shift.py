"""PyTorch port: the indel left shift (``kernels/shift_kernel.py``) bit-equal
to JAX's ``shift_kernel`` on the CPU, on the generators of
``tests/test_seq_kernels.py`` and ``tests/test_shift_winbase.py``, and stage
B's emission stream at K=257 with zero-length "other" ops."""

import numpy as np
import pytest
import torch

from portello_tpu.kernels import shift_kernel as jsk
from portello_tpu.ops import cigar as cg
from portello_tpu.ops.shift import left_shift_indels
from portello_tpu.testutil.simulate import apply_edits, rand_seq
from portello_tpu_torch.kernels import shift_kernel as tsk
from portello_tpu_torch.kernels.cigar_kernels import PAD
from tests.test_seq_kernels import MAX_CL, MAX_OUT, WIN, pad_batch, random_alignment


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, i)


def test_minplus_scan_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    a = rng.integers(0, 20000, size=(6, 129)).astype(np.int32)
    b = rng.integers(0, 60, size=(6, 129)).astype(np.int32)
    b[rng.random(b.shape) < 0.5] = tsk._INF
    a[:, 0] = 0
    b[:, 0] = 0
    got = tsk._minplus_scan(*_t(a, b))
    assert got.dtype == torch.int32
    for i in range(a.shape[0]):
        want = np.asarray(jsk._minplus_scan(jnp.asarray(a[i]), jnp.asarray(b[i])))
        assert np.array_equal(got[i].numpy(), want), i
    assert tsk._INF == jsk._INF


def _shift_both(arrs, mm, **kw):
    want = jsk.left_shift_batch(*arrs, mm=mm, **kw)
    got = tsk.left_shift_batch(*_t(*arrs), **kw)
    return got, want


def _compare(got, want, exact: bool):
    """All fields equal, or (``exact`` False) equal on the items neither
    side flags, with the port's flags a subset of JAX's."""
    if exact:
        _assert_equal(got, want, "left_shift_batch")
        return
    fb_g, fb_w = got[4].numpy(), np.asarray(want[4])
    assert not (fb_g & ~fb_w).any()
    keep = ~fb_g & ~fb_w
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g.numpy()[keep], np.asarray(w)[keep])


@pytest.mark.parametrize("mm", [False, True])
@pytest.mark.parametrize("seed", [8, 9])
def test_left_shift_matches_jax_on_seq_kernel_fuzz(mm, seed):
    rng = np.random.default_rng(seed)
    items = [random_alignment(rng) for _ in range(64)]
    arrs = pad_batch(items)
    got, want = _shift_both(arrs, mm, max_clusters=MAX_CL, window=WIN,
                            max_out=MAX_OUT)
    _compare(got, want, exact=not mm)
    # and the oracle, where the port does not flag the item
    fb = got[4].numpy()
    assert fb.sum() < len(items) // 4
    for i, (cig, pos, ref, read) in enumerate(items):
        if fb[i]:
            continue
        exp_pos, exp_cig = left_shift_indels(pos, cig, ref, read)
        n = int(got[2][i])
        out = np.stack([got[0][i, :n].numpy(), got[1][i, :n].numpy()], 1)
        assert int(got[3][i]) == exp_pos, i
        assert cg.to_string(out.astype(np.int64)) == cg.to_string(exp_cig), i


def _winbase_batch(rng, b=16, max_ops=64, max_seq=512):
    """tests/test_shift_winbase.py's items: windows cut out of a longer
    sequence at a nonzero absolute base; the oracle runs on the full one."""
    ops = np.full((b, max_ops), PAD, np.int32)
    lens = np.zeros((b, max_ops), np.int32)
    rel_pos = np.zeros(b, np.int32)
    win_base = np.zeros(b, np.int32)
    ref_win = np.zeros((b, max_seq), np.uint8)
    read_seq = np.zeros((b, max_seq), np.uint8)
    expects = []
    for i in range(b):
        full = rand_seq(rng, 1200)
        wb = int(rng.integers(0, 600))
        span = int(rng.integers(60, 250))
        rseq, rcig = apply_edits(full[wb: wb + span], rng, 0.01, 0.03, eqx=False)
        n = min(len(rcig), max_ops)
        ops[i, :n] = rcig[:n, 0]
        lens[i, :n] = rcig[:n, 1]
        win_base[i] = wb
        w_len = min(max_seq, len(full) - wb)
        ref_win[i, :w_len] = full[wb: wb + w_len]
        read_seq[i, : len(rseq)] = rseq[:max_seq]
        expects.append(left_shift_indels(wb, rcig[:n].astype(np.int64), full, rseq))
    return (ops, lens, rel_pos, win_base, ref_win, read_seq), expects


@pytest.mark.parametrize("mm", [False, True])
def test_left_shift_nonzero_win_base_matches_jax_and_oracle(mm):
    arrs, expects = _winbase_batch(np.random.default_rng(60601))
    got, want = _shift_both(arrs, mm, max_clusters=24, window=12, max_out=96)
    _compare(got, want, exact=not mm)
    fb = got[4].numpy()
    exact = 0
    for i, (p, c) in enumerate(expects):
        if fb[i]:
            continue
        n = int(got[2][i])
        out = np.stack([got[0][i, :n].numpy(), got[1][i, :n].numpy()], 1)
        # the port's position is window-relative, the oracle's absolute
        assert int(got[3][i]) + int(arrs[3][i]) == p, i
        assert np.array_equal(out.astype(np.int64), c), i
        exact += 1
    assert exact > 0


def test_stage_b_at_k257_with_zero_length_other_ops():
    """Stage B alone at the primary bucket's width (n = 128 ops, K = 257):
    soft clips, N and P ops of length 0 stay in the stream as real codes
    (``keep_zero``), cigars end in a match run so the trailing flush lands
    in a partial last 32-lane chunk; the stream and the compressed cigar
    equal JAX's."""
    import jax

    rng = np.random.default_rng(257)
    b, n = 8, 128
    items = [random_alignment(rng, max_len=400) for _ in range(b)]
    ops = np.full((b, n), PAD, np.int32)
    lens = np.zeros((b, n), np.int32)
    pos = np.zeros(b, np.int32)
    refw = np.zeros((b, 512), np.uint8)
    readw = np.zeros((b, 512), np.uint8)
    for i, (cig, p, ref, read) in enumerate(items):
        cig = cig.copy()
        if i % 2 == 0:      # zero-length "other" ops, inside and at the ends
            cig = np.concatenate([[(cg.S, 0)], cig, [(cg.N, 0)]])
            k = len(cig) // 2
            cig = np.concatenate([cig[:k], [(cg.P, 0), (cg.S, 0)], cig[k:]])
        ops[i, : len(cig)] = cig[:, 0]
        lens[i, : len(cig)] = cig[:, 1]
        pos[i] = p
        refw[i, : len(ref)] = ref
        readw[i, : len(read)] = read
    ops[b - 1, :] = cg.M    # a full row: 128 ops, the whole width used
    lens[b - 1, :] = 1
    base = np.zeros(b, np.int32)
    kw = dict(max_clusters=MAX_CL, window=WIN)
    st_t = tsk.shift_stage_a(*_t(ops, lens, pos, base, refw, readw), **kw)
    st_j = jsk.shift_stage_a_batch(ops, lens, pos, base, refw, readw, **kw)
    codes_t, lens_t, fb_t = tsk.shift_stage_b_emit(
        *_t(ops, lens), st_t, window=WIN
    )
    assert codes_t.shape == (b, 2 * n + 1) and codes_t.dtype == torch.int32
    zero_other = (codes_t != PAD) & (codes_t != cg.M) & (lens_t == 0)
    assert bool(zero_other.any())
    for key in st_t:
        assert np.array_equal(st_t[key].numpy(), np.asarray(st_j[key])), key

    max_out = 128
    got = tsk.shift_stage_b(*_t(ops, lens, pos), st_t, window=WIN,
                            max_out=max_out)
    want = jsk.shift_stage_b_batch(ops, lens, pos, st_j, window=WIN,
                                   max_out=max_out)
    _assert_equal(got, jax.device_get(want), "shift_stage_b K=257")
    assert np.array_equal(fb_t.numpy() | got[4].numpy(), got[4].numpy())
