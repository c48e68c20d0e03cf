"""The port's copies of ``auxlib/`` (basemod, BigWig) and
``utils/{misc,containers,prob}.py`` against the JAX package's originals: the
inputs of ``test_aux_components.py``, ``test_bigwig.py`` and
``test_clip_score_utils.py`` through both, with equal results (and, for
``write_bigwig``, equal file bytes)."""

import numpy as np
import pytest

from portello_tpu.auxlib import basemod as jax_basemod
from portello_tpu.auxlib import bigwig as jax_bigwig
from portello_tpu.io.bam import BamHeader as JaxBamHeader
from portello_tpu.io.bam import BamRecord as JaxBamRecord
from portello_tpu.utils import containers as jax_containers
from portello_tpu.utils import misc as jax_misc
from portello_tpu.utils import prob as jax_prob
from portello_tpu_torch.auxlib import basemod as port_basemod
from portello_tpu_torch.auxlib import bigwig as port_bigwig
from portello_tpu_torch.io.bam import BamHeader as PortBamHeader
from portello_tpu_torch.io.bam import BamRecord as PortBamRecord
from portello_tpu_torch.utils import containers as port_containers
from portello_tpu_torch.utils import misc as port_misc
from portello_tpu_torch.utils import prob as port_prob

# SAM lines of test_aux_components.py's basemod cases: no tags, forward,
# skip mode with a non-CpG C, reverse strand, and a mod of another base.
BASEMOD_SAM = (
    "q\t4\t*\t0\t255\t*\t*\t0\t0\tACGCCGTA\tIIIIIIII",
    "q\t0\tchr1\t100\t60\t8M\t*\t0\t0\tACGCCGTA\tIIIIIIII\t"
    "MM:Z:C+m,0,1;\tML:B:C,200,100",
    "q\t0\tchr1\t100\t60\t8M\t*\t0\t0\tACGCCGTA\tIIIIIIII\t"
    "MM:Z:C+m?,0,0,0;\tML:B:C,10,20,30",
    "q\t16\tchr1\t100\t60\t8M\t*\t0\t0\tTACGGCGT\tIIIIIIII\t"
    "MM:Z:C+m,0,1;\tML:B:C,200,100",
    "q\t0\tchr1\t100\t60\t8M\t*\t0\t0\tACGCCGTA\tIIIIIIII\t"
    "MM:Z:A+a,0;\tML:B:C,5",
)


def _meth(info):
    """A decode result as plain values: the error code, or the fields."""
    if isinstance(info, int):
        return info
    return (sorted(info.pos_prob.items()), info.skip_mode.name)


@pytest.mark.parametrize("sam", BASEMOD_SAM)
def test_decode_cpg_meth_info_equals_jax(sam):
    jax_rec = JaxBamRecord.from_sam(
        JaxBamHeader.from_refs([("chr1", 10_000_000)]), sam)
    port_rec = PortBamRecord.from_sam(
        PortBamHeader.from_refs([("chr1", 10_000_000)]), sam)
    assert _meth(port_basemod.decode_cpg_meth_info(port_rec)) == _meth(
        jax_basemod.decode_cpg_meth_info(jax_rec))


def test_decode_ml_equals_jax():
    assert [port_basemod.decode_ml(v) for v in range(256)] == [
        jax_basemod.decode_ml(v) for v in range(256)]


def _chroms_intervals(seed):
    """test_bigwig.py's cases: fixed intervals on two chromosomes (seed
    None), or random gapped spans over two chromosomes, enough for zoom
    levels and many sections."""
    if seed is None:
        return [("chr1", 10000), ("chr2", 5000)], [
            ("chr1", 0, 100, 1.5), ("chr1", 100, 250, 2.0),
            ("chr1", 5000, 5010, -3.25), ("chr2", 10, 20, 7.0),
        ]
    rng = np.random.default_rng(seed)
    chroms = [("chr1", 100_000), ("chr2", 40_000)]
    ivs = []
    for name, ln in chroms:
        pos = 0
        while pos < ln - 50:
            span = int(rng.integers(5, 40))
            ivs.append((name, pos, pos + span,
                        float(np.float32(rng.normal()))))
            pos += span + int(rng.integers(0, 30))
    return chroms, ivs


@pytest.mark.parametrize("seed", [None, 5, 11])
def test_write_bigwig_bytes_equal_jax(tmp_path, seed):
    chroms, ivs = _chroms_intervals(seed)
    jax_path, port_path = str(tmp_path / "jax.bw"), str(tmp_path / "port.bw")
    jax_bigwig.write_bigwig(jax_path, chroms, ivs)
    port_bigwig.write_bigwig(port_path, chroms, ivs)
    with open(jax_path, "rb") as f:
        want = f.read()
    with open(port_path, "rb") as f:
        assert f.read() == want
    with jax_bigwig.BigWigReader(jax_path) as jr, \
            port_bigwig.BigWigReader(port_path) as pr:
        assert list(pr.intervals()) == list(jr.intervals()) == ivs
        assert pr.summary() == jr.summary()
        assert pr.zoom_levels == jr.zoom_levels
        for lvl in range(pr.zoom_levels):
            assert list(pr.zoom_records(lvl)) == list(jr.zoom_records(lvl))


def test_write_coverage_bigwig_bytes_equal_jax(tmp_path):
    depth = np.zeros(1000, np.int32)
    depth[100:200] = 3
    depth[200:205] = 1
    jax_path, port_path = str(tmp_path / "jax.bw"), str(tmp_path / "port.bw")
    jax_bigwig.write_coverage_bigwig(jax_path, [("chr1", 1000)], {"chr1": depth})
    port_bigwig.write_coverage_bigwig(port_path, [("chr1", 1000)], {"chr1": depth})
    with open(jax_path, "rb") as f, open(port_path, "rb") as g:
        assert g.read() == f.read()


def test_ring_buffer_and_window_sum_equal_jax():
    def drive(mod):
        rb = mod.RingBuffer(3)
        for i in range(5):
            rb.push(i)
        w = mod.SparseWindowSum(5)
        sums = []
        for op, *args in (("add", 0), ("add", 2), ("add", 4, 3),
                          ("advance", 2), ("add", 6), ("advance", 100)):
            getattr(w, op)(*args)
            sums.append(w.sum())
        return len(rb), rb.to_list(), [rb[i] for i in range(3)], sums

    assert drive(port_containers) == drive(jax_containers)


@pytest.mark.parametrize("logs", [
    np.log([0.1, 0.2, 0.7]), np.array([0.0, 0.0]), np.log([0.1, 0.7, 0.2]),
    np.array([]),
])
def test_prob_utils_equal_jax(logs):
    assert port_prob.log_sum_exp(logs) == jax_prob.log_sum_exp(logs)
    p_out, p_i = port_prob.normalize_ln_distro(logs)
    j_out, j_i = jax_prob.normalize_ln_distro(logs)
    assert p_i == j_i
    np.testing.assert_array_equal(p_out, j_out)


def test_misc_utils_equal_jax():
    def drive(mod):
        t = mod.MeanTracker()
        t.insert(2.0)
        t.insert(4.0)
        t2 = mod.MeanTracker()
        t2.insert(6.0)
        t.merge(t2)
        v = list(range(1, 14))
        return (
            t.mean(),
            [mod.downsample_vector(v, i) for i in range(15)],
            list(mod.array_segmenter([0, 1, 2, -1, 4, 5, 6, 7, 8, 9],
                                     lambda x: x < 0)),
            mod.drop_true([1, 2, 3, 4, 5], [True, False, False, True, False]),
        )

    assert drive(port_misc) == drive(jax_misc)
