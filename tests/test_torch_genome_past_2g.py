"""The resident genome past byte 2^31, as a whole GRCh38 layout puts every
read-bearing chromosome after chr12: the native feed's slot arrays, the
joined global bases, the plain window fetches and ``fwd_batch_resident`` on
a genome of over 2 GiB allocated with ``torch.empty`` (only the items'
windows are written, so its pages stay untouched), equal to the table step
on the same items; and a ``--device cpu`` native-feed CLI run on a layout of
25 chromosomes whose reads lie on the last three, whose records equal
``--device host``'s and whose stats count the resident genome; and the
run's genome freed as the run returns."""

import ctypes
import os

import numpy as np
import pytest
import torch

from portello_tpu_torch.kernels import resident as tres
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.pipeline import native_feed as nf
from portello_tpu_torch.testutil import batchgen as tbg

SB = tres.SB
GENOME_BYTES = (1 << 31) + (1 << 20)
FLANK = 2 * SB
STRIDE = 1 << 16
STARTS = (0, 100, 250)
WIN = 48


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        line = next(ln for ln in f if ln.startswith("VmRSS:"))
    return int(line.split()[1]) * 1024


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def test_resident_path_past_2g_equals_table_step():
    bcfg = BucketConfig(max_ops=32, max_blocks=16, max_seq=512,
                        max_clusters=24, window=48)
    b, width = 16, bcfg.max_seq
    rng = np.random.default_rng(6)
    arrays = list(tbg.make_item_arrays(rng, b, bcfg, read_len=400,
                                       read_error=0.03, contig_var_rate=0.01))
    ops, lens, n_ops, pos, bk, bv, nb, ref_win, _, read_seq = arrays
    # each item at its own chromosome coordinate, as a read deep in a
    # chromosome is: its window starts there and its lifted blocks move by it
    coord = rng.integers(1_000_000, 200_000_000, size=b).astype(np.int32)
    bv = np.where(bv >= 0, bv + coord[:, None], bv).astype(np.int32)
    ref_base = coord.copy()
    arrays[5], arrays[8] = bv, ref_base

    rss0 = _rss_bytes()
    genome = torch.empty(GENOME_BYTES, dtype=torch.uint8)
    # item i on chromosome i + 1 (chromosome 0 holds the first 2 GiB), which
    # starts 64-aligned; its window lies past byte 2^31, the last one ending
    # within 200 bytes of the genome's end (its two tail superblocks kept)
    target = (1 << 31) + FLANK + np.arange(b, dtype=np.int64) * STRIDE
    target[-1] = GENOME_BYTES - 2 * SB - width
    goff = np.zeros(b + 1, np.int64)
    goff[0] = SB
    goff[1:] = (target - coord) // SB * SB
    place = goff[1:] + coord
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(b):
        o = int(place[i])
        genome[o - FLANK:o] = torch.from_numpy(rng.choice(acgt, size=FLANK))
        genome[o:o + width] = torch.from_numpy(ref_win[i])
    assert place.min() >= 1 << 31
    assert GENOME_BYTES - 200 <= place[-1] + width <= GENOME_BYTES - 2 * SB

    # the scanner's resident slot as ptscan_next_batch hands it over
    ref_chrom = np.arange(1, b + 1, dtype=np.int32)
    packed = tres.pack_seq_rows(read_seq)
    d = nf._BatchDesc()
    d.count = b
    for name, a in (("ops", ops), ("lens", lens), ("n_ops", n_ops), ("pos", pos),
                    ("bk", bk), ("bv", bv), ("nb", nb), ("ref_base", ref_base),
                    ("ref_chrom", ref_chrom)):
        setattr(d, name, _ptr(a, ctypes.c_int32))
    d.read_packed = _ptr(packed, ctypes.c_uint8)

    res = nf._resident_slot_arrays(d, bcfg, b, goff)
    for got, want in zip(res[:7], arrays[:7]):
        assert np.array_equal(got, want)
    assert np.array_equal(res[9], ref_base) and np.array_equal(res[10], packed)
    g_sb, g_off = res[7], res[8]
    assert g_sb.dtype == np.int32 and g_off.dtype == np.int32
    g_base = tres.global_base(torch.from_numpy(g_sb), torch.from_numpy(g_off))
    assert g_base.dtype == torch.int64 and g_base.tolist() == place.tolist()
    assert nf._items_past_2g(g_sb, b) == b
    assert nf._items_past_2g(g_sb, b // 2) == b // 2

    # the plain window fetches read the items' rows back
    starts = torch.tensor(STARTS, dtype=torch.int32).expand(b, -1)
    got = tres.ref_windows(genome, g_base[:, None], starts, WIN)
    reads = tres.read_windows_packed(torch.from_numpy(packed), starts, WIN)
    for i in range(b):
        for j, s in enumerate(STARTS):
            assert bytes(got[i, j].numpy()) == ref_win[i, s:s + WIN].tobytes()
            assert bytes(reads[i, j].numpy()) == read_seq[i, s:s + WIN].tobytes()

    kw = tpm.bucket_kwargs(bcfg)
    want = tpm.fwd_batch(*tpm.batch_from_numpy(tuple(arrays), "cpu"), **kw)
    step = tpm.fwd_batch_resident(*tpm.resident_batch_from_numpy(res, "cpu"),
                                  genome, **kw)
    assert set(step) == set(want)
    for key in want:
        assert torch.equal(step[key], want[key]), key
    assert bool(want["mapped"].any())
    # the genome's pages stay untouched: its windows cost a few pages each
    assert _rss_bytes() - rss0 < 256 << 20


FILLERS = 22  # chromosomes before the scenario's chr1, one between chr1 and chr2


def _many_chromosomes(d: str) -> list[int]:
    """The scenario's reference and contig alignments rewritten onto 25
    chromosomes: 22 of filler bases, then chr1, one more filler and chr2, so
    every contig, and every read, lies on the last three.  Returns the
    chromosome lengths."""
    from portello_tpu_torch.io.bam import BamHeader, BamReader, BamWriter
    from portello_tpu_torch.io.fasta import get_genome_ref_from_fasta, write_fasta
    from portello_tpu_torch.io.index_build import build_bai

    rng = np.random.default_rng(25)
    old = get_genome_ref_from_fasta(os.path.join(d, "ref.fa")).chroms
    filler = [(f"chrF{i}", rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                     size=int(rng.integers(70, 3000))))
              for i in range(FILLERS + 1)]
    chroms = filler[:FILLERS] + [("chr1", old["chr1"]), filler[FILLERS],
                                 ("chr2", old["chr2"])]
    write_fasta(os.path.join(d, "ref.fa"), [(n, s.tobytes()) for n, s in chroms])
    tid = {n: i for i, (n, _) in enumerate(chroms)}
    bam = os.path.join(d, "asm_to_ref.bam")
    with BamReader(bam) as r:
        names = [n for n, _ in r.header.refs]
        recs = list(r)
    for rec in recs:
        rec.tid = tid[names[rec.tid]]
        rec.raw = None  # encode the new tid, not the bytes read
    os.remove(bam + ".bai")
    header = BamHeader.from_refs([(n, len(s)) for n, s in chroms])
    with BamWriter(bam, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(bam)
    return [len(s) for _, s in chroms]


def test_cli_resident_on_last_chromosomes_equals_host(tmp_path, monkeypatch):
    from portello_tpu_torch.testutil.simulate import make_scenario
    from portello_tpu_torch.testutil.spill import sam_records

    if nf.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {nf.build_error()}")
    d = str(tmp_path)
    make_scenario(d, rng=np.random.default_rng(19), n_reads_per_contig=30,
                  read_len=300)
    lengths = _many_chromosomes(d)

    def args(tag, device, *extra):
        return ["--assembly-to-ref", os.path.join(d, "asm_to_ref.bam"),
                "--read-to-assembly", os.path.join(d, "read_to_asm.bam"),
                "--remapped-read-output", os.path.join(d, f"remapped_{tag}.bam"),
                "--unassembled-read-output", os.path.join(d, f"un_{tag}.bam"),
                "--ref", os.path.join(d, "ref.fa"),
                "--device", device, "--batch-size", "16", *extra]

    from portello_tpu_torch.main import main as port_main

    stats = []
    run = nf.scan_and_remap_reads_native
    monkeypatch.setattr(nf, "scan_and_remap_reads_native",
                        lambda *a, **k: stats.append(run(*a, **k)) or stats[-1])
    monkeypatch.delenv("PTPU_RESIDENT", raising=False)
    monkeypatch.delenv("PTPU_HOST_SHIFT", raising=False)
    port_main(args("cpu", "cpu", "--feed", "native"))
    port_main(args("host", "host"))
    assert len(stats) == 1
    for kind in ("remapped", "un"):
        assert (sam_records(os.path.join(d, f"{kind}_cpu.bam"))
                == sam_records(os.path.join(d, f"{kind}_host.bam"))), kind
    remapped = sam_records(os.path.join(d, "remapped_cpu.bam"))
    assert remapped
    assert {line.split("\t")[2] for line in remapped} <= {"chr1", "chrF22", "chr2", "*"}
    st = stats[0]
    assert st["resident"] and st["device_items"] > 0
    # the table: a front pad superblock, each chromosome 64-aligned, two
    # tail superblocks
    assert st["genome_bytes"] == SB + sum(-(-n // SB) * SB for n in lengths) + 2 * SB
    assert st["items_past_2g"] == 0


def test_run_frees_its_genome_when_it_returns(tmp_path, monkeypatch):
    """The run's compiled steps hold the resident genome; the run clears its
    step cache as it ends, which frees them with no cyclic collection (at a
    whole GRCh38's size each replica left behind keeps 3.09 GB on the
    card)."""
    import gc
    import weakref

    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.testutil.simulate import make_scenario

    if nf.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {nf.build_error()}")
    d = str(tmp_path)
    make_scenario(d, rng=np.random.default_rng(5), n_reads_per_contig=10,
                  read_len=300)
    replicas = []
    alloc = nf.alloc_genome

    def alloc_kept(lengths, mesh):
        goff, tables = alloc(lengths, mesh)
        replicas.extend(weakref.ref(g) for g in tables.values())
        return goff, tables

    monkeypatch.setattr(nf, "alloc_genome", alloc_kept)
    monkeypatch.delenv("PTPU_RESIDENT", raising=False)
    monkeypatch.delenv("PTPU_HOST_SHIFT", raising=False)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        port_main([
            "--assembly-to-ref", os.path.join(d, "asm_to_ref.bam"),
            "--read-to-assembly", os.path.join(d, "read_to_asm.bam"),
            "--remapped-read-output", os.path.join(d, "remapped.bam"),
            "--unassembled-read-output", os.path.join(d, "un.bam"),
            "--ref", os.path.join(d, "ref.fa"),
            "--device", "cpu", "--feed", "native", "--batch-size", "16"])
        assert replicas and nf._last_stats["device_items"] > 0
        assert all(r() is None for r in replicas)
    finally:
        if was_enabled:
            gc.enable()
