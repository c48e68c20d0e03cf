"""PyTorch port: cleanup+compress (plain path) bit-equal to the JAX XLA form
and to the Pallas TPU kernel in interpret mode.

Tolerance 0 throughout: every value is an integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from portello_tpu.kernels import cigar_kernels as jck
from portello_tpu.kernels.pallas.compress_pallas import cleanup_and_compress_batch
from portello_tpu_torch.kernels import cigar_kernels as tck

MAX_OUT = 232


def _jax(codes, lens, max_out=MAX_OUT):
    out = jax.vmap(lambda c, l: jck.cleanup_and_compress(c, l, max_out, False))(
        jnp.asarray(codes), jnp.asarray(lens)
    )
    return [np.asarray(x) for x in out]


def _port(codes, lens, max_out=MAX_OUT):
    out = tck.cleanup_and_compress(
        torch.from_numpy(codes), torch.from_numpy(lens), max_out
    )
    return [x.numpy() for x in out]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), i


def _streams(seed, b, k, max_len=24000):
    """Random streams with zero lengths and the edge rows of
    tests/test_pallas_compress.py."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 10, size=(b, k)).astype(np.int32)
    lens = rng.integers(0, max_len, size=(b, k)).astype(np.int32)
    lens[rng.random((b, k)) < 0.3] = 0
    codes[0, :] = tck.PAD                # all PAD
    lens[1, :] = 0                       # all zero length
    codes[2, :] = tck.PAD                # one op
    codes[2, 0] = 0
    lens[2, 0] = 5
    codes[3, :4] = [2, 1, 0, 2]          # D I M D: edge del/ins both sides
    lens[3, :4] = [3, 2, 7, 4]
    codes[3, 4:] = tck.PAD
    for i in range(8, b, 4):             # runs of one code, PAD tails
        codes[i] = np.repeat(rng.integers(0, 10, size=k // 6 + 1), 6)[:k]
        codes[i, rng.integers(k // 2, k):] = tck.PAD
    return codes, lens


def test_op_code_constants_match():
    for name in ("M", "I", "D", "N", "S", "H", "P", "EQ", "X", "PAD"):
        assert getattr(tck, name) == getattr(jck, name), name
    assert tck.INT32_MAX == int(jck.INT32_MAX)


@pytest.mark.parametrize("k", [352, 464])
def test_cleanup_and_compress_matches_xla(k):
    codes, lens = _streams(17 + k, 48, k)
    _assert_equal(_port(codes, lens), _jax(codes, lens))


@pytest.mark.parametrize("k", [352, 464])
def test_cleanup_and_compress_matches_pallas_interpret(k):
    codes, lens = _streams(29 + k, 16, k, max_len=1 << 16)
    with pltpu.force_tpu_interpret_mode():
        want = cleanup_and_compress_batch(
            jnp.asarray(codes), jnp.asarray(lens), MAX_OUT, interpret=True
        )
    want = [np.asarray(x) for x in want]
    got = _port(codes, lens)
    _assert_equal(got, want)


def test_run_overflow_flag_matches():
    k = 352
    codes = np.tile(np.tile(np.array([0, 1], np.int32), k // 2)[None, :], (8, 1))
    lens = np.ones((8, k), np.int32)  # alternating M/I: k runs > MAX_OUT
    got = _port(codes, lens)
    assert got[4].all() and (got[2] == MAX_OUT).all()
    _assert_equal(got, _jax(codes, lens))


def test_lens_at_and_above_2_16_are_exact_not_flagged():
    """The port sums in exact int32 like the XLA form; unlike the Pallas
    kernel's byte planes it has no 2^16 limit and raises no overflow."""
    k = 352
    codes = np.full((8, k), tck.PAD, np.int32)
    lens = np.zeros((8, k), np.int32)
    codes[0, :3] = [0, 2, 0]
    lens[0, :3] = [70000, 5, 9]
    codes[1, :4] = [2, 0, 0, 1]
    lens[1, :4] = [1 << 16, (1 << 16) - 1, 1 << 20, 3]
    codes[2, :2] = [0, 0]
    lens[2, :2] = [1 << 30, 12345]
    got = _port(codes, lens)
    assert not got[4].any()
    assert got[1][0, 0] == 70000 and got[1][2, 0] == (1 << 30) + 12345
    _assert_equal(got, _jax(codes, lens))


@pytest.mark.parametrize("max_out", [8, 1800])
def test_cleanup_and_compress_max_out_edges(max_out):
    codes, lens = _streams(5, 24, 96)
    _assert_equal(_port(codes, lens, max_out), _jax(codes, lens, max_out))


def test_cigar_read_len_matches():
    codes, lens = _streams(3, 24, 64)
    want = np.asarray(jax.vmap(jck.cigar_read_len)(codes, lens))
    got = tck.cigar_read_len(torch.from_numpy(codes), torch.from_numpy(lens))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    codes, lens = _streams(1, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tck.cleanup_and_compress_cuda(
            torch.from_numpy(codes), torch.from_numpy(lens), MAX_OUT
        )
