"""The input generator: the same seed gives the same bytes, the port's BAM
reader parses what it writes, and each mix's share of items per bucket is
recorded."""

import hashlib
import os

import pytest

from benchmark.gen import build
from benchmark.tests import tiny


def _digests(meta):
    out = {}
    for key in ("fasta", "contig_bam", "reads_bam"):
        for path in (meta[key], meta[key] + ".bai"):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("mix_name", ["revio", "longinsert"])
def test_same_seed_same_bytes(tmp_path, mix_name):
    conf, mix = tiny.config("hg002-revio-grch38"), tiny.mix(mix_name, 120)
    a = build.build(conf, mix, 2**31 + 11, str(tmp_path / "a"))
    b = build.build(conf, mix, 2**31 + 11, str(tmp_path / "b"))
    c = build.build(conf, mix, 2**31 + 12, str(tmp_path / "c"))
    assert _digests(a) == _digests(b)
    assert _digests(a)["reads.bam"] != _digests(c)["reads.bam"]
    # every seed gets the same amount of work
    assert (a["n_reads"], a["n_primary"], a["n_unmapped"], a["n_split"]) == (
        c["n_reads"], c["n_primary"], c["n_unmapped"], c["n_split"])


def test_port_reader_parses_inputs(tmp_path):
    from portello_tpu_torch.io.bam import BamReader
    from portello_tpu_torch.io.fasta import get_genome_ref_from_fasta

    conf, mix = tiny.config("hg002-revio-grch38"), tiny.mix("revio", 200)
    meta = build.build(conf, mix, 7, str(tmp_path))
    for engine in ("python", "auto"):
        with BamReader(meta["reads_bam"], load_index=True, engine=engine) as r:
            recs = list(r)
            unplaced = list(r.fetch_unmapped())
        assert len(recs) == meta["n_records"]
        assert len(unplaced) == meta["n_unmapped"]
        assert sum(not (x.flag & 0x904) for x in recs) == meta["n_primary"]
        with BamReader(meta["contig_bam"], load_index=True, engine=engine) as r:
            contigs = list(r)
            hits = list(r.fetch(0, 0, conf["chromosomes"][0][1]))
        assert {c.qname.decode() for c in contigs} == {c["name"] for c in conf["contigs"]}
        assert len(hits) == sum(len(c["parts"]) for c in conf["contigs"]
                                if c["chrom"] == conf["chromosomes"][0][0])
    genome = get_genome_ref_from_fasta(meta["fasta"])
    assert [(n, len(s)) for n, s in genome.chroms.items()] == [
        (n, ln) for n, ln in conf["chromosomes"]]


@pytest.mark.parametrize("mix_name,primary,spill", [
    ("revio", (0.85, 0.95), (0.04, 0.15)),
    ("longinsert", (0.45, 0.65), (0.35, 0.55)),
])
def test_bucket_shares_recorded(tmp_path, mix_name, primary, spill):
    meta = build.build(tiny.config("hg002-revio-grch38", 20), tiny.mix(mix_name, 2000),
                       5, str(tmp_path))
    shares = meta["bucket_share"]
    assert len(shares) == len(build.BUCKETS) + 1
    assert abs(sum(shares) - 1) < 1e-5
    assert primary[0] <= shares[0] <= primary[1]
    assert spill[0] <= shares[1] + shares[2] <= spill[1]
    if mix_name == "longinsert":
        assert shares[2] > 0.3  # the tail to 60 kb fills the wide bucket


def test_bucket_table_is_the_programs():
    from benchmark.lib.buckets import BUCKETS
    from portello_tpu_torch.models.pipeline_model import DEFAULT_BUCKETS

    assert [tuple(b) for b in BUCKETS] == [
        (b.max_ops, b.max_blocks, b.max_seq, b.max_clusters) for b in DEFAULT_BUCKETS]
