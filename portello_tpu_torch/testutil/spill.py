"""Inputs and checks for the spill path: the mid and wide buckets, the items
they flag, and the reads past every bucket that the host finishes.

Jax-free counterparts of the JAX package's test and soak helpers, for the
port's tests, ``scripts/torch_*.py`` and ``chip_smoke.py`` (the GPU machine
has no JAX, and those helpers import it):

- the hostile-rate fuzz of ``tests/test_fuzz_conformance.py``: ``BCFG``,
  ``KW``, ``B``, ``expect_fwd``, ``expect_rev`` (the numpy oracle),
  ``check_batch``, ``hostile_rounds`` (its seeds draw the same batches as
  that test's) and ``cluster_overflow_batch`` (its cluster-overflow item);
- ``check_native``: the same contract against the exact C++ core
  (``ops/native_core.py``), fast enough for B=512 wide-bucket batches;
- ``spill_batch``: B items of ``make_item_arrays`` shaped for one of
  ``DEFAULT_BUCKETS``, in chunks that worker processes can build;
- ``build_inputs``: the spill and fallback reads of
  ``tests/test_engine_fallbacks.py``;
- ``build_scenario``: the WGS-shaped scenario of ``scripts/soak_scale.py``
  (same records for the same seed).

Every check raises ``Mismatch`` (an ``AssertionError``) naming the item and
the first field that differs.
"""

from __future__ import annotations

import os

import numpy as np

from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.ops import cigar as cg
from portello_tpu_torch.ops.blockmap import BlockMap
from portello_tpu_torch.ops.liftover import liftover_read_alignment
from portello_tpu_torch.ops.shift import left_shift_indels
from portello_tpu_torch.ops.simplify import simplify_alignment_indels
from portello_tpu_torch.testutil.batchgen import make_item_arrays
from portello_tpu_torch.testutil.simulate import rand_seq, rev_comp

# Small bucket so static bounds are genuinely stressed (overflow -> fallback).
BCFG = BucketConfig(max_ops=64, max_blocks=32, max_seq=1024, max_clusters=24,
                    window=12)
KW = dict(
    max_out=BCFG.resolved_max_out(),
    max_clusters=BCFG.max_clusters,
    window=BCFG.window,
    max_rows=BCFG.resolved_max_rows(),
)
B = 16

# (read length range, read error range) of the items ``spill_batch`` makes
# for each of ``DEFAULT_BUCKETS``: HiFi reads for the primary bucket, ~20 kb
# reads at 129-256 ops for the mid bucket, 25-60 kb reads for the wide one.
SPILL_SHAPES = (
    ((2_000, 18_000), (0.0025, 0.012)),
    ((19_000, 21_000), (0.0095, 0.0095)),
    ((25_000, 60_000), (0.009, 0.009)),
)


class Mismatch(AssertionError):
    """A step's unflagged item differs from the exact reference."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise Mismatch(msg)


def new_counters() -> dict:
    return {"exact": 0, "fallback": 0, "unmapped": 0}


def _host(out) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def expect_fwd(args, i):
    """The numpy oracle's (ref2_pos, cigar) for item ``i`` of a
    ``fwd_batch`` batch, or None when it does not map."""
    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq = args
    n = int(n_ops[i])
    cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
    k = int(nb[i])
    bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
    lifted = liftover_read_alignment(bm, int(pos[i]), cig)
    if lifted is None:
        return None
    p, c = lifted
    rp, rc = simplify_alignment_indels(
        p - int(ref_base[i]), c, ref_win[i], read_seq[i]
    )
    return int(ref_base[i]) + rp, rc


def expect_rev(args, i):
    """``expect_fwd`` for a ``rev_batch`` batch: the left shift on the
    reversed contig first."""
    (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
     ref_win, ref_base, read_seq) = args
    n = int(n_ops[i])
    cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
    p1, sh = left_shift_indels(int(pos[i]) - int(win_base[i]), cig,
                               contig_win[i], read_seq[i])
    k = int(nb[i])
    bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
    lifted = liftover_read_alignment(bm, p1 + int(win_base[i]), sh)
    if lifted is None:
        return None
    p, c = lifted
    rp, rc = simplify_alignment_indels(
        p - int(ref_base[i]), c, ref_win[i], read_seq[i]
    )
    return int(ref_base[i]) + rp, rc


def _check_item(host, i, expect, what) -> str:
    """Item ``i`` of a step's output against ``expect`` (None: unmapped;
    else (ref2_pos, (n, 2) cigar)); returns the counter it falls in."""
    if expect is None:
        _require(not host["mapped"][i],
                 f"{what}: item {i} maps, the reference does not")
        return "unmapped"
    p, cig = expect
    _require(bool(host["mapped"][i]),
             f"{what}: item {i} unmapped, the reference maps it")
    n = int(host["n_out"][i])
    _require(n == len(cig), f"{what}: item {i} field n_out {n} != {len(cig)}")
    _require(int(host["ref2_pos"][i]) == p,
             f"{what}: item {i} field ref2_pos {int(host['ref2_pos'][i])} "
             f"!= {p}")
    got = np.stack([host["codes"][i, :n], host["lens"][i, :n]], axis=1)
    _require(np.array_equal(got.astype(np.int64), np.asarray(cig, np.int64)),
             f"{what}: item {i} field codes/lens differ")
    return "exact"


def check_batch(out, args, expect_fn, counters, what="step") -> None:
    """Every item a step did not flag equals the numpy oracle
    (``expect_fwd`` or ``expect_rev``); counts exact, flagged and unmapped
    items into ``counters``."""
    host = _host(out)
    for i in range(len(host["fallback"])):
        if host["fallback"][i]:
            counters["fallback"] += 1
            continue
        counters[_check_item(host, i, expect_fn(args, i), what)] += 1


def native_expect(args, max_out: int, rev: bool = False):
    """The exact C++ core's outputs for a ``fwd_batch`` (or, with ``rev``,
    ``rev_batch``) batch: (codes, lens, n, pos), where n is -1 for an
    unmapped item and -2 where the result overflows ``max_out`` (or, for
    a reverse item, the shifted cigar overflows its bound)."""
    from portello_tpu_torch.ops import native_core

    n_threads = min(os.cpu_count() or 1, 8)
    if not rev:
        return native_core.lift_simplify_batch(*args, max_out,
                                               n_threads=n_threads)
    (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
     ref_win, ref_base, read_seq) = args
    s_codes, s_lens, s_n, s_pos = native_core.shift_batch(
        ops, lens, n_ops, pos - win_base, contig_win, read_seq,
        ops.shape[1] + 8, n_threads=n_threads,
    )
    over = s_n < 0
    codes, olens, n, opos = native_core.lift_simplify_batch(
        s_codes, s_lens, np.where(over, 0, s_n).astype(np.int32),
        (s_pos + win_base).astype(np.int32), bk, bv, nb, ref_win, ref_base,
        read_seq, max_out, n_threads=n_threads,
    )
    n[over] = -2
    return codes, olens, n, opos


def check_native(out, args, max_out: int, counters, rev: bool = False,
                 what="step") -> None:
    """Every item a step did not flag equals the exact C++ core
    (``native_expect``): unmapped where it is unmapped, else the same
    position and cigar; an unflagged item whose reference result overflows
    is a mismatch.  Counts into ``counters`` as ``check_batch``."""
    host = _host(out)
    codes, lens, n, pos = native_expect(args, max_out, rev)
    for i in range(len(host["fallback"])):
        if host["fallback"][i]:
            counters["fallback"] += 1
            continue
        _require(n[i] != -2, f"{what}: item {i} not flagged, but its exact "
                 f"result overflows {max_out} ops")
        expect = None if n[i] == -1 else (
            int(pos[i]), np.stack([codes[i, :n[i]], lens[i, :n[i]]], axis=1))
        counters[_check_item(host, i, expect, what)] += 1


def _resident_args(fwd_args):
    """``fwd_batch_resident``'s inputs (without the genome) and the genome
    for a table batch, the rows laid out by ``build_global_ref``."""
    from portello_tpu_torch.testutil.batchgen import resident_from_table

    g_sb, g_off, packed, genome = resident_from_table(fwd_args)
    return tuple(fwd_args[:7]) + (g_sb, g_off, fwd_args[8], packed), genome


def run_steps(fwd_args, rev_args, device, kw) -> dict:
    """``fwd_batch``, ``fwd_batch_resident`` and ``rev_batch`` on
    ``device``; returns their outputs by name."""
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.pipeline_model import (
        batch_from_numpy,
        fwd_batch,
        fwd_batch_resident,
        resident_batch_from_numpy,
        rev_batch,
        rev_batch_from_numpy,
    )

    res_args, genome = _resident_args(fwd_args)
    return {
        "fwd": fwd_batch(*batch_from_numpy(fwd_args, device), **kw),
        "resident": fwd_batch_resident(
            *resident_batch_from_numpy(res_args, device),
            genome_tensor(genome, device), **kw),
        "rev": rev_batch(*rev_batch_from_numpy(rev_args, device), **kw),
    }


def hostile_rounds(seed: int, device, counters=None) -> dict:
    """The hostile-rate fuzz of ``tests/test_fuzz_conformance.py`` for one
    seed on the port: three rounds of forward and reverse batches (the same
    arrays that test draws for ``seed``) through ``fwd_batch``,
    ``fwd_batch_resident`` and ``rev_batch`` on ``device``.  Every
    unflagged item must equal the numpy oracle and the C++ core.  Returns
    the counters, each item counted once (in the oracle's check)."""
    counters = new_counters() if counters is None else counters
    rng = np.random.default_rng(77000 + seed)
    for _ in range(3):
        read_len = int(rng.integers(30, 600))
        read_error = float(10 ** rng.uniform(-2.5, -1.0))
        contig_rate = float(10 ** rng.uniform(-2.5, -1.1))
        fwd_args = make_item_arrays(
            rng, B, BCFG, read_len=read_len, read_error=read_error,
            contig_var_rate=contig_rate, rev=False,
        )
        rev_args = make_item_arrays(
            rng, B, BCFG, read_len=read_len, read_error=read_error,
            contig_var_rate=contig_rate, rev=True,
        )
        outs = run_steps(fwd_args, rev_args, device, KW)
        for name, out in outs.items():
            args = rev_args if name == "rev" else fwd_args
            what = f"seed {seed} {name}"
            check_batch(out, args, expect_rev if name == "rev"
                        else expect_fwd, counters, what)
            check_native(out, args, KW["max_out"], new_counters(),
                         rev=name == "rev", what=what)
    return counters


def cluster_overflow_batch() -> tuple:
    """A small-bucket forward batch whose item 0 has more indel clusters
    (28) than the bucket's budget (24): the step must flag it, and the
    other items stay exact."""
    n_cl = BCFG.max_clusters + 4
    ops_l = []
    for _ in range(n_cl):
        ops_l += [(cg.I, 1), (cg.M, 4)]
    hostile = np.array(ops_l, np.int64)
    rng = np.random.default_rng(4242)
    args = list(make_item_arrays(rng, B, BCFG, read_len=200, rev=False))
    ops, lens, n_ops = args[0].copy(), args[1].copy(), args[2].copy()
    n = len(hostile)
    ops[0, :] = 9  # PAD
    lens[0, :] = 0
    ops[0, :n] = hostile[:, 0]
    lens[0, :n] = hostile[:, 1]
    n_ops[0] = n
    args[0], args[1], args[2] = ops, lens, n_ops
    return tuple(args)


# -------------------------------------------------------------- spill batches
def concat_batches(parts) -> tuple:
    """One batch of the batches ``parts`` (tuples of arrays), row-wise."""
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def make_chunk(job) -> tuple:
    """One chunk of ``spill_jobs``: ``make_item_arrays(rev=True)`` with its
    own generator, read length and error rate."""
    seed, n, bucket, read_len, read_error = job
    from portello_tpu_torch.models.pipeline_model import DEFAULT_BUCKETS

    return make_item_arrays(np.random.default_rng(seed), n,
                            DEFAULT_BUCKETS[bucket], read_len=read_len,
                            read_error=read_error, rev=True)


def spill_jobs(seed: int, b: int, bucket: int, chunk: int = 32) -> list:
    """The chunks of ``b`` items for ``DEFAULT_BUCKETS[bucket]``, shaped by
    ``SPILL_SHAPES``: ``chunk`` items each, each chunk with its own read
    length (log-uniform over the bucket's range), error rate and seed.
    ``make_chunk`` builds one (in any process), ``concat_batches`` joins
    them."""
    (lo, hi), (elo, ehi) = SPILL_SHAPES[bucket]
    rng = np.random.default_rng(seed)
    sizes = [min(chunk, b - s) for s in range(0, b, chunk)]
    seeds = rng.integers(0, 2**63 - 1, size=len(sizes))
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi), size=len(sizes)))
    errs = rng.uniform(elo, ehi, size=len(sizes))
    return [(int(s), n, bucket, int(rl), float(e))
            for s, n, rl, e in zip(seeds, sizes, lens, errs)]


def spill_batch(seed: int, b: int, bucket: int, chunk: int = 32,
                executor=None) -> tuple:
    """``b`` items of ``make_item_arrays`` for ``DEFAULT_BUCKETS[bucket]``
    (``spill_jobs``), built by ``executor`` (see ``item_pool``) where
    given: ``rev_batch``'s inputs (``fwd_of_rev`` gives ``fwd_batch``'s)."""
    jobs = spill_jobs(seed, b, bucket, chunk)
    return concat_batches((executor.map if executor else map)(make_chunk, jobs))


def item_pool(workers: int | None = None):
    """A pool of spawned worker processes for ``spill_batch`` (one per CPU
    core, at most 8, by default); close it with ``shutdown`` or use it in a
    ``with`` block."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = workers or min(os.cpu_count() or 1, 8)
    return ProcessPoolExecutor(workers, multiprocessing.get_context("spawn"))


def fwd_of_rev(rev_args) -> tuple:
    """The ``fwd_batch`` inputs of a ``rev_batch`` batch at window base 0
    (its contig row is then the read's own contig)."""
    return tuple(rev_args[:4]) + tuple(rev_args[6:])


# ------------------------------------------------------------ CLI outputs
# The CRAM flavours a scenario's reads are written in: (version, profile).
CRAM_FLAVOURS = {
    "21": dict(version=(2, 1)),
    "30": dict(version=(3, 0)),
    "31": dict(version=(3, 1)),
    "arch": dict(version=(3, 1), profile="archive"),
}


def write_crams(bam: str, tags=tuple(CRAM_FLAVOURS)) -> dict:
    """The records of ``bam`` written as CRAM in each flavour of ``tags``
    (``CRAM_FLAVOURS``), beside it as ``<name>_<tag>.cram`` with a .crai;
    returns their paths by tag."""
    from portello_tpu_torch.io.bam import BamReader
    from portello_tpu_torch.io.cram import CramWriter

    with BamReader(bam) as r:
        recs = list(r)
        header = r.header
    paths = {}
    for tag in tags:
        paths[tag] = f"{os.path.splitext(bam)[0]}_{tag}.cram"
        with CramWriter(paths[tag], header, **CRAM_FLAVOURS[tag]) as w:
            for rec in recs:
                w.write(rec)
    return paths


def sam_records(path: str, zero_unmapped_mapq: bool = False,
                collapse_eqx: bool = False) -> list:
    """The sorted SAM lines of a BAM.  ``zero_unmapped_mapq`` sets an
    unmapped record's MAPQ to 0, and ``collapse_eqx`` writes ``=`` and
    ``X`` ops as ``M``: what a CRAM input does not keep (``io/cram.py``)."""
    from portello_tpu_torch.io.bam import BamReader

    out = []
    with BamReader(path) as r:
        for rec in r:
            if zero_unmapped_mapq and rec.is_unmapped():
                rec.mapq = 0
            if collapse_eqx and len(rec.cigar):
                c = rec.cigar.copy()
                c[:, 0] = np.where((c[:, 0] == cg.EQ) | (c[:, 0] == cg.X),
                                   cg.M, c[:, 0])
                rec.cigar = c
            out.append(rec.to_sam(r.header))
    return sorted(out)


# ------------------------------------------------- fallback reads (CLI input)
def build_inputs(tmp):
    """The reads of ``tests/test_engine_fallbacks.py`` in directory
    ``tmp``: one that fits only the spill bucket (> 256 ops), a deletion
    in a 300-base homopolymer on the reverse contig (saturates the shift
    window), one past every bucket (> 1,024 ops), 60 adjacent I+D
    clusters, and a plain read on each contig.  Returns the paths of the
    contig BAM, the read BAM and the reference FASTA."""
    from portello_tpu_torch.io.bam import FREVERSE, BamHeader, BamRecord, BamWriter
    from portello_tpu_torch.io.fasta import write_fasta
    from portello_tpu_torch.io.index_build import build_bai

    tmp = str(tmp)
    rng = np.random.default_rng(3)
    chrom = np.concatenate(
        [rand_seq(rng, 4000), np.full(300, ord("A"), np.uint8),
         rand_seq(rng, 4000)]
    )
    ref_header = BamHeader.from_refs([("chr1", len(chrom))])
    ctg_fwd = chrom.copy()
    ctg_rev_seq = rev_comp(chrom)
    contigs = [("ctg_fwd", ctg_fwd, False), ("ctg_rev", ctg_rev_seq, True)]
    contig_bam = os.path.join(tmp, "asm.bam")
    with BamWriter(contig_bam, ref_header) as w:
        for name, seq, is_rev in contigs:
            w.write(BamRecord(
                qname=name.encode(), flag=FREVERSE if is_rev else 0, tid=0,
                pos=0, mapq=60, cigar=cg.cigar((cg.EQ, len(chrom))),
                seq=rev_comp(seq) if is_rev else seq,
                qual=np.full(len(chrom), 40, np.uint8),
            ))
    build_bai(contig_bam)

    contig_header = BamHeader.from_refs([(n, len(chrom)) for n, _, _ in contigs])
    contig_seqs = {0: ctg_fwd, 1: ctg_rev_seq}
    reads = []

    def add_read(qname, tid, pos, cigar, seq):
        reads.append(BamRecord(
            qname=qname.encode(), flag=0, tid=tid, pos=pos, mapq=50,
            cigar=cigar, seq=seq, qual=np.full(len(seq), 30, np.uint8),
        ))

    # (a) spill bucket: > 256 cigar ops (alternating 1M1I)
    ops, parts, cp = [], [], 100
    rng2 = np.random.default_rng(4)
    for _ in range(300):
        ops.append((cg.M, 1))
        parts.append(contig_seqs[0][cp:cp + 1])
        cp += 1
        ops.append((cg.I, 1))
        parts.append(rand_seq(rng2, 1))
    ops.append((cg.M, 50))
    parts.append(contig_seqs[0][cp:cp + 50])
    add_read("spill_bucket", 0, 100, np.array(ops, np.int64),
             np.concatenate(parts))

    # (b) window saturation: a deletion inside the homopolymer on the
    # reverse contig (left-shift homology longer than the window of 48)
    p0 = len(chrom) - 4300 - 100
    ln1, dln, ln2 = 150, 100, 150
    seq_b = np.concatenate([
        contig_seqs[1][p0:p0 + ln1],
        contig_seqs[1][p0 + ln1 + dln:p0 + ln1 + dln + ln2],
    ])
    add_read("window_saturate", 1, p0,
             cg.cigar((cg.M, ln1), (cg.D, dln), (cg.M, ln2)), seq_b)

    # (c) beyond all buckets: > 1024 ops
    ops, parts, cp = [], [], 200
    for _ in range(1100):
        ops.append((cg.M, 2))
        parts.append(contig_seqs[0][cp:cp + 2])
        cp += 2
        ops.append((cg.D, 1))
        cp += 1
    add_read("all_host", 0, 200, cg.compress_cigar(np.array(ops, np.int64)),
             np.concatenate(parts))

    # (d) 60 adjacent I+D clusters
    ops, parts, cp = [], [], 1000
    rng3 = np.random.default_rng(5)
    for _ in range(60):
        ops.append((cg.M, 5))
        parts.append(contig_seqs[0][cp:cp + 5])
        cp += 5
        ops.append((cg.I, 2))
        parts.append(rand_seq(rng3, 2))
        ops.append((cg.D, 2))
        cp += 2
    ops.append((cg.M, 50))
    parts.append(contig_seqs[0][cp:cp + 50])
    add_read("many_mixed", 0, 1000, np.array(ops, np.int64),
             np.concatenate(parts))

    add_read("plain_fwd", 0, 500, cg.cigar((cg.M, 400)), contig_seqs[0][500:900])
    add_read("plain_rev", 1, 700, cg.cigar((cg.M, 400)),
             contig_seqs[1][700:1100])

    reads.sort(key=lambda r: (r.tid, r.pos))
    read_bam = os.path.join(tmp, "reads.bam")
    with BamWriter(read_bam, contig_header) as w:
        for r in reads:
            w.write(r)
    build_bai(read_bam)
    fasta = os.path.join(tmp, "ref.fa")
    write_fasta(fasta, [("chr1", chrom.tobytes())])
    return contig_bam, read_bam, fasta


# ------------------------------------------------------ WGS-shaped scenario
def _edited_walk(rng, ref, lo, hi, event_bp, max_indel=6):
    """A sequence and cigar derived from ref[lo:hi): M runs copied from the
    reference with an I or D event every ~event_bp (geometric gaps).
    Loops over events, not bases."""
    parts = []
    ops = []
    pos = lo
    while pos < hi:
        gap = int(rng.geometric(1.0 / event_bp))
        run = min(gap, hi - pos)
        parts.append(ref[pos:pos + run])
        if ops and ops[-1][0] == cg.M:
            ops[-1] = (cg.M, ops[-1][1] + run)
        else:
            ops.append((cg.M, run))
        pos += run
        if pos >= hi:
            break
        ln = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:
            parts.append(rand_seq(rng, ln))
            ops.append((cg.I, ln))
        else:
            ln = min(ln, hi - pos)
            ops.append((cg.D, ln))
            pos += ln
    return (
        np.concatenate(parts) if parts else np.zeros(0, np.uint8),
        ops,
    )


def build_scenario(root, n_reads, rng) -> int:
    """The WGS-shaped scenario of ``scripts/soak_scale.py`` in ``root``:
    chromosomes of 3 Mbp and 1.5 Mbp tiled by three contigs (forward,
    reverse, forward) at about one indel per 800 bp, and ``n_reads`` reads
    of log-uniform 2-60 kb length with an indel about every 150 bp, so long
    reads spill to the mid and wide buckets.  Writes ``ref.fa``,
    ``asm_to_ref.bam`` and ``read_to_asm.bam`` (indexed); returns the
    number of reads written."""
    from portello_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter
    from portello_tpu_torch.tools.index import build_bai

    os.makedirs(root, exist_ok=True)
    chrom_len = 3_000_000
    chr1 = rand_seq(rng, chrom_len)
    chr2 = rand_seq(rng, chrom_len // 2)
    with open(os.path.join(root, "ref.fa"), "wb") as f:
        for name, seq in (("chr1", chr1), ("chr2", chr2)):
            f.write(f">{name}\n".encode())
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80].tobytes() + b"\n")

    ref_header = BamHeader.from_refs([("chr1", len(chr1)), ("chr2", len(chr2))])
    specs = [("ctg1", 0, chr1, 5_000, 2_600_000, True),
             ("ctg2", 0, chr1, 2_610_000, 2_990_000, False),
             ("ctg3", 1, chr2, 10_000, 1_480_000, True)]
    contigs = []
    contig_records = []
    for name, tid, chrom, lo, hi, fwd in specs:
        seq, ops = _edited_walk(rng, chrom, lo, hi, event_bp=800)
        cig = cg.cigar(*ops)
        rec = BamRecord(
            qname=name.encode(), flag=0 if fwd else 16, tid=tid, pos=lo,
            mapq=60, cigar=cig if fwd else cig[::-1].copy(),
            seq=seq if fwd else rev_comp(seq),
            qual=np.full(len(seq), 40, np.uint8),
        )
        rec.push_tag(b"NM", b"i", 0)
        contig_records.append(rec)
        contigs.append((name, seq, fwd))
    contig_records.sort(key=lambda r: (r.tid, r.pos))
    cbam = os.path.join(root, "asm_to_ref.bam")
    with BamWriter(cbam, ref_header) as w:
        for r in contig_records:
            w.write(r)
    build_bai(cbam)

    contig_header = BamHeader.from_refs(
        [(name, len(seq)) for name, seq, _ in contigs]
    )
    rbam = os.path.join(root, "read_to_asm.bam")
    lens = np.exp(
        rng.uniform(np.log(2_000), np.log(60_000), size=n_reads)
    ).astype(np.int64)
    tids = rng.integers(0, len(contigs), size=n_reads)
    n_written = 0
    with BamWriter(rbam, contig_header) as w:
        for ci, (name, cseq, _fwd) in enumerate(contigs):
            idx = np.nonzero(tids == ci)[0]
            starts = rng.integers(
                0, np.maximum(len(cseq) - lens[idx], 1), size=len(idx)
            )
            order = np.argsort(starts, kind="stable")
            for k in order:
                ri, pos, want = int(idx[k]), int(starts[k]), int(lens[idx[k]])
                hi = min(pos + want, len(cseq))
                rseq, ops = _edited_walk(rng, cseq, pos, hi, event_bp=150)
                if not len(rseq):
                    continue
                rec = BamRecord(
                    qname=f"read{ri:06d}".encode(),
                    flag=0 if rng.random() < 0.5 else 16,
                    tid=ci, pos=pos, mapq=int(rng.integers(10, 61)),
                    cigar=cg.cigar(*ops), seq=rseq,
                    qual=rng.integers(10, 50, size=len(rseq)).astype(np.uint8),
                )
                rec.push_tag(b"NM", b"i", 0)
                w.write(rec)
                n_written += 1
    build_bai(rbam)
    return n_written
