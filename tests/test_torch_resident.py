"""PyTorch port, resident slot mode: the numpy helpers and window fetches
byte-equal to ``portello_tpu.kernels.resident``, and ``fwd_batch_resident``
equal to JAX's table step and, on the items JAX does not flag, to JAX's
resident step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portello_tpu.kernels import resident as jres
from portello_tpu.models import pipeline_model as jpm
from portello_tpu_torch.kernels import resident as tres
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.testutil import batchgen as tbg

WIN = 48
KW = dict(max_out=256, max_clusters=32, window=WIN, max_rows=160)
FIELDS = ("codes", "lens", "n_out", "ref2_pos", "mapped", "read_len", "fallback")


def _chroms(rng, sizes=(700, 333), alpha=b"ACGTN"):
    a = np.frombuffer(alpha, np.uint8)
    return [rng.choice(a, size=n) for n in sizes]


def test_constants_and_lut_equal_jax():
    assert tres.SB == jres.SB
    assert tres.SEQ_SYMBOLS == jres.SEQ_SYMBOLS
    assert np.array_equal(tres._ENC_LUT, jres._ENC_LUT)


def test_build_global_ref_split_and_pack_equal_jax():
    rng = np.random.default_rng(3)
    chroms = [rng.integers(0, 256, size=n, dtype=np.uint8)
              for n in (10, 64, 129, 1)]
    tw, tg = tres.build_global_ref(chroms)
    jw, jg = jres.build_global_ref(chroms)
    assert tw.dtype == jw.dtype and np.array_equal(tw, jw)
    assert tg.dtype == jg.dtype and np.array_equal(tg, jg)
    # offsets past 2^31 (a GRCh38-sized genome) split without loss
    gbyte = np.array([0, 63, 64, 2**31 - 1, 2**31, 2**31 + 77, 3_100_000_123],
                     np.int64)
    ts, to = tres.split_global_base(gbyte)
    js, jo = jres.split_global_base(gbyte)
    assert np.array_equal(ts, js) and np.array_equal(to, jo)
    assert ts.dtype == np.int32 and to.dtype == np.int32
    joined = tres.global_base(torch.from_numpy(ts), torch.from_numpy(to))
    assert joined.dtype == torch.int64 and joined.tolist() == gbyte.tolist()
    alpha = np.frombuffer(tres.SEQ_SYMBOLS + b"acgtnXY", np.uint8)
    for length in (400, 401):
        rows = rng.choice(alpha, size=(5, length))
        rows[:, -7:] = 0
        tp = tres.pack_seq_rows(rows)
        assert tp.shape == (5, (length + 1) // 2)
        assert np.array_equal(tp, jres.pack_seq_rows(rows))


def test_genome_tensor_round_trips():
    rng = np.random.default_rng(4)
    words, _ = tres.build_global_ref(
        [rng.integers(60, 100, size=n, dtype=np.uint8) for n in (300, 70)]
    )
    g = tres.genome_tensor(words, "cpu")
    assert g.dtype == torch.uint8 and g.dim() == 1
    assert bytes(g.numpy()) == words.tobytes()
    flat = words.view(np.uint8).reshape(-1)
    assert torch.equal(tres.genome_tensor(flat, "cpu"), g)
    back = g.numpy().reshape(-1, tres.SB).view(np.uint32)
    assert np.array_equal(back, words)
    with pytest.raises(ValueError):
        tres.genome_tensor(words.astype(np.int64), "cpu")


def test_ref_windows_equal_fetch_ref_windows_global():
    # the cases of the JAX package's test_fetch_ref_windows_global_exact
    rng = np.random.default_rng(7)
    chroms = [rng.integers(60, 100, size=n, dtype=np.uint8)
              for n in (300, 64, 129)]
    words, goff = tres.build_global_ref(chroms)
    cases = []
    for _ in range(64):
        ci = int(rng.integers(0, len(chroms)))
        base = int(rng.integers(0, len(chroms[ci])))
        start = int(rng.integers(-WIN, len(chroms[ci]) - base + 8))
        cases.append((ci, base, start))
    cases += [(0, 0, -WIN), (2, 128, 0), (1, 63, 40)]
    g_sb, g_off = tres.split_global_base(
        np.array([goff[c] + b for c, b, _ in cases], np.int64)
    )
    starts = np.array([s for _, _, s in cases], np.int32)
    want = np.asarray(jres.fetch_ref_windows_global(
        jnp.asarray(words), jnp.asarray(g_sb), jnp.asarray(g_off),
        jnp.asarray(starts), WIN,
    ))                                                      # (WIN, C)
    got = tres.ref_windows(
        tres.genome_tensor(words, "cpu"),
        tres.global_base(torch.from_numpy(g_sb), torch.from_numpy(g_off)),
        torch.from_numpy(starts), WIN,
    )                                                       # (C, WIN)
    assert np.array_equal(got.numpy().T, want)


def test_read_windows_packed_equal_fetch_read_windows_packed():
    # the cases of the JAX package's test_pack_fetch_read_windows_exact,
    # compared on every position, including the out-of-row fill
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(tres.SEQ_SYMBOLS, np.uint8)
    g, length = 5, 400
    rows = rng.choice(alpha, size=(g, length))
    rows[:, -7:] = 0
    packed = tres.pack_seq_rows(rows)
    starts = rng.integers(-WIN, length - WIN, size=(g, 3)).astype(np.int32)
    starts[0, 0] = -WIN
    starts[1, 1] = length - WIN
    starts[2, 2] = 33
    starts[3, 0] = length          # entirely past the row
    starts[4, 1] = -WIN + 1        # odd parity before the row
    want = np.asarray(jres.fetch_read_windows_packed(
        jnp.asarray(packed), jnp.asarray(starts), WIN
    ))                                                      # (G, WIN, 3)
    got = tres.read_windows_packed(
        torch.from_numpy(packed), torch.from_numpy(starts), WIN
    )                                                       # (G, 3, WIN)
    assert np.array_equal(got.numpy().transpose(0, 2, 1), want)
    # the fill widens to 'N' at even and 'D' at odd positions
    past = got[3, 0].numpy()
    assert bytes(past[0::2]) == b"N" * (WIN // 2)
    assert bytes(past[1::2]) == b"D" * (WIN // 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fwd_batch_resident_equals_jax_table_step(seed):
    rng = np.random.default_rng(seed)
    chroms = _chroms(rng)
    words, goff = tres.build_global_ref(chroms)
    table_args, res_args = tbg.resident_table_pair(
        rng, 24, max_ops=64, max_blocks=8, max_seq=512, chroms=chroms,
        goff=goff,
    )
    want = jpm.fwd_batch(*table_args, mm=False, **KW)
    got = tpm.fwd_batch_resident(
        *tpm.resident_batch_from_numpy(res_args, "cpu"),
        tres.genome_tensor(words, "cpu"), **KW,
    )
    assert set(got) == set(FIELDS)
    for key in FIELDS:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        assert np.array_equal(got[key].numpy(), w), key
    assert int(got["mapped"].sum()) > 12


def test_fwd_batch_resident_vs_jax_resident_step():
    """Equal on every item JAX does not flag; the port flags a subset (it
    has no mixed-cluster budget, so items with 3 mixed clusters that JAX
    sends to the host stay on the device here)."""
    rng = np.random.default_rng(5)
    chroms = _chroms(rng)
    words, goff = tres.build_global_ref(chroms)
    table_args, res_args = tbg.resident_table_pair(
        rng, 24, max_ops=64, max_blocks=8, max_seq=512, chroms=chroms,
        goff=goff,
    )
    want = jpm.fwd_batch_resident(*res_args, jnp.asarray(words), **KW)
    got = tpm.fwd_batch_resident(
        *tpm.resident_batch_from_numpy(res_args, "cpu"),
        tres.genome_tensor(words, "cpu"), **KW,
    )
    jfb = np.asarray(want["fallback"])
    pfb = got["fallback"].numpy()
    assert not (pfb & ~jfb).any()
    assert (jfb & ~pfb).any()   # the budget flags of the JAX step
    keep = ~jfb
    for key in FIELDS:
        assert np.array_equal(got[key].numpy()[keep],
                              np.asarray(want[key])[keep]), key
    # the port's own results on the items JAX flags equal its table step
    table = tpm.fwd_batch(*tpm.batch_from_numpy(table_args, "cpu"), **KW)
    for key in FIELDS:
        assert torch.equal(got[key], table[key]), key


@pytest.mark.parametrize("genome_bytes", [None, 200_000])
def test_resident_from_table_equals_table_step(genome_bytes):
    bcfg = BucketConfig(max_ops=32, max_blocks=16, max_seq=512,
                        max_clusters=24, window=48)
    arrays = tbg.make_item_arrays(
        np.random.default_rng(6), 16, bcfg, read_len=400, read_error=0.03,
        contig_var_rate=0.01,
    )
    g_sb, g_off, packed, genome = tbg.resident_from_table(
        arrays, genome_bytes, np.random.default_rng(1)
    )
    assert genome.dtype == np.uint8 and genome.shape[0] % tres.SB == 0
    assert packed.shape == (16, 256)
    base = (g_sb.astype(np.int64) << 6) | g_off
    for i in range(16):
        assert np.array_equal(genome[base[i]:base[i] + 512], arrays[7][i])
    if genome_bytes is not None:
        assert genome.shape[0] == genome_bytes
        # spread up to the end, two tail superblocks kept
        assert base[-1] + 512 > genome_bytes - 3 * tres.SB
        assert base[-1] + 512 <= genome_bytes - 2 * tres.SB
    kw = tpm.bucket_kwargs(bcfg)
    want = tpm.fwd_batch(*tpm.batch_from_numpy(arrays, "cpu"), **kw)
    res = tuple(arrays[:7]) + (g_sb, g_off, arrays[8], packed)
    got = tpm.fwd_batch_resident(
        *tpm.resident_batch_from_numpy(res, "cpu"),
        tres.genome_tensor(genome, "cpu"), **kw,
    )
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_resident_batch_from_numpy_checks_inputs():
    rng = np.random.default_rng(2)
    chroms = _chroms(rng, (300,))
    _, goff = tres.build_global_ref(chroms)
    _, res_args = tbg.resident_table_pair(
        rng, 4, max_ops=64, max_blocks=8, max_seq=512, chroms=chroms, goff=goff
    )
    t = tpm.resident_batch_from_numpy(res_args, "cpu")
    assert [x.dtype for x in t] == [d for _, d in tpm.RESIDENT_FIELDS]
    with pytest.raises(ValueError):
        tpm.resident_batch_from_numpy(res_args[:-1], "cpu")
    bad = list(res_args)
    bad[7] = bad[7].astype(np.int64)
    with pytest.raises(ValueError, match="g_sb"):
        tpm.resident_batch_from_numpy(bad, "cpu")

