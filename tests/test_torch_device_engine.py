"""PyTorch port: the Python feed's ``DeviceEngine`` on the CPU, under
host-shift and device-shift routing, writes the same sorted records as the
JAX package's ``DeviceEngine`` and as the exact host path, with the same
item counters; the fallback counters of ``tests/test_engine_fallbacks.py``
on its inputs; and zero-length ops on reverse-contig items routed to the
host under device-shift routing."""

import numpy as np
import pytest
import torch

from portello_tpu.io.bam import BamReader, BamWriter
from portello_tpu.io.fasta import get_genome_ref_from_fasta
from portello_tpu.io.index_build import build_bai
from portello_tpu.models.pipeline_model import DeviceEngine as JaxEngine
from portello_tpu.ops import cigar as cg
from portello_tpu.pipeline.contig_scan import scan_contig_bam
from portello_tpu.pipeline.read_scan import scan_and_remap_reads
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu.utils.chrom_list import ChromList
from portello_tpu_torch.models.pipeline_model import DeviceEngine
from tests.test_engine_fallbacks import build_inputs

COUNTERS = ("device_items", "host_items", "fallback_items")


def _records(path):
    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def _phase1(contig_bam, read_bam, fasta):
    ref_cl = ChromList.from_bam_filename(contig_bam)
    asm_cl = ChromList.from_bam_filename(read_bam)
    genome = get_genome_ref_from_fasta(fasta)
    reference = [genome.chroms[c.label] for c in ref_cl.data]
    info = scan_contig_bam(contig_bam, ref_cl, asm_cl, None)
    return reference, ref_cl, asm_cl, info


def _run(tmp_path, tag, read_bam, p1, engine):
    reference, ref_cl, _, info = p1
    out = tmp_path / f"r_{tag}.bam"
    un = tmp_path / f"u_{tag}.bam"
    scan_and_remap_reads(read_bam, str(out), str(un), reference, ref_cl, info,
                         False, engine=engine)
    return _records(out), _records(un)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine")
    scn = make_scenario(str(d), rng=np.random.default_rng(41),
                        n_reads_per_contig=30, read_len=350)
    return d, scn, _phase1(scn.contig_bam, scn.read_bam, scn.ref_fasta)


@pytest.mark.parametrize("host_shift", [True, False])
def test_engine_matches_jax_engine_and_host(scenario, host_shift):
    d, scn, p1 = scenario
    reference, _, asm_cl, info = p1
    tag = f"hs{int(host_shift)}"
    port = DeviceEngine(reference, asm_cl, info, torch.device("cpu"),
                        batch_size=64, host_shift=host_shift)
    jax_engine = JaxEngine(reference, asm_cl, info, batch_size=64,
                           platform="cpu", use_mm=False, host_shift=host_shift)
    got = _run(d, f"port_{tag}", scn.read_bam, p1, port)
    assert got == _run(d, f"jax_{tag}", scn.read_bam, p1, jax_engine)
    assert got == _run(d, f"host_{tag}", scn.read_bam, p1, None)
    assert len(got[0]) > 0
    for key in COUNTERS:
        assert port.stats[key] == jax_engine.stats[key], key
    assert port.stats["device_items"] > 0
    assert (port.stats["rev_batches"] > 0) == (not host_shift)
    assert port.stats["batches"] > port.stats["rev_batches"]
    # on CPU tensors the plain versions run: no kernel launches
    assert set(port.stats["kernel_launches"].values()) == {0}


def test_engine_fallback_counters(tmp_path):
    """The reads of tests/test_engine_fallbacks.py under device-shift
    routing: the spill bucket, the saturated homology window of a reverse
    read (the device flags it) and a read beyond every bucket."""
    contig_bam, read_bam, fasta = build_inputs(tmp_path)
    p1 = _phase1(contig_bam, read_bam, fasta)
    reference, _, asm_cl, info = p1
    port = DeviceEngine(reference, asm_cl, info, "cpu", batch_size=16,
                        host_shift=False)
    jax_engine = JaxEngine(reference, asm_cl, info, batch_size=16,
                           platform="cpu", use_mm=False, host_shift=False)
    got = _run(tmp_path, "port", read_bam, p1, port)
    assert got == _run(tmp_path, "host", read_bam, p1, None)
    assert got == _run(tmp_path, "jax", read_bam, p1, jax_engine)
    assert port.stats["host_items"] >= 2
    assert port.stats["fallback_items"] >= 1
    assert port.stats["device_items"] >= 3
    assert port.stats["rev_batches"] >= 1
    for key in COUNTERS:
        assert port.stats[key] == jax_engine.stats[key], key


def test_zero_length_op_on_reverse_item_goes_to_host(tmp_path):
    """A zero-length I op on a reverse-contig read would form a phantom
    cluster in the device left shift; under device-shift routing the engine
    finishes such items on the host, and the output equals the host path."""
    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(37))
    p1 = _phase1(scn.contig_bam, scn.read_bam, scn.ref_fasta)
    reference, _, asm_cl, info = p1
    rev_tids = [
        ci for ci in range(len(asm_cl.data))
        if info[ci].ordered_contig_segment_info
        and all(not s.seq_order_segment.is_fwd_strand
                for s in info[ci].ordered_contig_segment_info)
    ]
    assert rev_tids
    with BamReader(scn.read_bam) as r:
        recs = list(r)
        header = r.header
    injected = 0
    for rec in recs:
        if (rec.tid in rev_tids and not rec.is_unmapped()
                and not rec.is_supplementary()
                and rec.get_string_tag(b"SA") is None):
            c = rec.cigar
            k = int(np.flatnonzero((c[:, 0] == cg.M) & (c[:, 1] >= 2))[0])
            rec.cigar = np.concatenate(
                [c[:k], [[cg.M, 1], [cg.I, 0], [cg.M, c[k, 1] - 1]], c[k + 1:]]
            ).astype(np.int64)
            rec.raw = None  # invalidate the encode cache
            injected += 1
    assert injected > 0
    bad = str(tmp_path / "read_to_asm_zl.bam")
    with BamWriter(bad, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(bad)

    port = DeviceEngine(reference, asm_cl, info, "cpu", batch_size=32,
                        host_shift=False)
    got = _run(tmp_path, "zl", bad, p1, port)
    assert got == _run(tmp_path, "zl_host", bad, p1, None)
    assert port.stats["host_items"] >= injected
    assert port.stats["fallback_items"] == 0
