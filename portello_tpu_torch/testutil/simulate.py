"""Synthetic liftover scenarios: reference genome -> edited contigs -> reads.

Generates the three pipeline inputs (ref FASTA, contig-to-ref BAM, read-to-
assembly BAM, both indexed) with fully known ground truth, used by the
end-to-end tests and the benchmark harness.  The reference repo has no
equivalent (its tests stop at unit vectors, SURVEY.md section 4); this closes
that gap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portello_tpu_torch.io.bam import FREVERSE, FSUPPLEMENTARY, FUNMAP, BamHeader, BamRecord, BamWriter
from portello_tpu_torch.io.fasta import write_fasta
from portello_tpu_torch.io.index_build import build_bai
from portello_tpu_torch.ops import cigar as cg
from portello_tpu_torch.ops.seq import rev_comp

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.choice(BASES, size=n)


def apply_edits(
    ref_seg: np.ndarray, rng: np.random.Generator, snp_rate: float, indel_rate: float,
    max_indel: int = 6, eqx: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Randomly edit a reference segment; return (derived_seq, cigar).

    ``eqx=True`` emits =/X match ops (minimap2 --eqx contig style, required by
    the repeat trimmer's GCI scoring); otherwise plain M.
    """
    out_seq: list[np.ndarray] = []
    ops: list[tuple[int, int]] = []
    i = 0
    n = len(ref_seg)
    match_code = cg.EQ if eqx else cg.M
    run = 0

    def flush_run():
        nonlocal run
        if run:
            ops.append((match_code, run))
            run = 0

    while i < n:
        r = rng.random()
        if r < snp_rate:
            flush_run()
            old = ref_seg[i]
            new = old
            while new == old:
                new = rng.choice(BASES)
            out_seq.append(np.array([new], np.uint8))
            ops.append((cg.X if eqx else cg.M, 1))
            i += 1
        elif r < snp_rate + indel_rate:
            flush_run()
            ln = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5 and i + ln < n:  # deletion
                ops.append((cg.D, ln))
                i += ln
            else:  # insertion
                out_seq.append(rand_seq(rng, ln))
                ops.append((cg.I, ln))
        else:
            out_seq.append(ref_seg[i : i + 1])
            run += 1
            i += 1
    flush_run()
    seq = np.concatenate(out_seq) if out_seq else np.zeros(0, np.uint8)
    return seq, cg.compress_cigar(np.array(ops, dtype=np.int64))


@dataclass
class SimContig:
    name: str
    seq: np.ndarray                      # contig sequence (its own orientation)
    # segments: (ref_tid, ref_pos, cigar_vs_ref_fwd, is_fwd, contig coords span)
    segments: list[tuple] = field(default_factory=list)


@dataclass
class Scenario:
    ref_fasta: str
    contig_bam: str
    read_bam: str
    ref_chroms: list[tuple[str, bytes]]
    contigs: list[SimContig]
    n_reads: int
    n_unmapped: int
    read_infos: list  # (qname, contig_idx, contig_pos, strand, cigar)


def _contig_record(
    header: BamHeader, contig: SimContig, seg_idx: int, all_segs_sa: str | None
) -> BamRecord:
    tid, pos, cigar, is_fwd, _span = contig.segments[seg_idx]
    # BAM stores the sequence in ref-forward orientation.
    seq = contig.seq if is_fwd else rev_comp(contig.seq)
    flag = 0 if is_fwd else FREVERSE
    if seg_idx > 0:
        flag |= FSUPPLEMENTARY
    rec = BamRecord(
        qname=contig.name.encode(), flag=flag, tid=tid, pos=pos, mapq=60,
        cigar=cigar, seq=seq, qual=np.full(len(seq), 40, np.uint8),
    )
    if all_segs_sa:
        rec.push_tag(b"SA", b"Z", all_segs_sa)
    return rec


def _sa_segment_str(header: BamHeader, tid, pos, cigar, is_fwd, mapq=60) -> str:
    chrom = header.refs[tid][0]
    return f"{chrom},{pos + 1},{'+' if is_fwd else '-'},{cg.to_string(cigar)},{mapq},0;"


def make_scenario(
    tmpdir: str,
    rng: np.random.Generator | None = None,
    n_reads_per_contig: int = 40,
    read_len: int = 300,
    chrom_len: int = 20000,
    read_snp_rate: float = 0.002,
    read_indel_rate: float = 0.002,
) -> Scenario:
    """Build a 4-contig scenario: forward, reverse, ref-split, and
    reverse-split (inversion) contigs."""
    import os

    rng = rng or np.random.default_rng(42)
    chr1 = rand_seq(rng, chrom_len)
    chr2 = rand_seq(rng, chrom_len // 2)
    ref_chroms = [("chr1", chr1.tobytes()), ("chr2", chr2.tobytes())]
    ref_header = BamHeader.from_refs([("chr1", len(chr1)), ("chr2", len(chr2))])

    contigs: list[SimContig] = []

    # ctg1: forward, simple edits, spans chr1[1000:1000+8000)
    seg = chr1[1000:9000]
    seq1, cig1 = apply_edits(seg, rng, 0.001, 0.0005)
    contigs.append(
        SimContig("ctg1", seq1, [(0, 1000, cig1, True, (0, len(seq1)))])
    )

    # ctg2: reverse-mapped contig over chr1[10000:16000)
    seg = chr1[10000:16000]
    fwd_proj, cig2 = apply_edits(seg, rng, 0.001, 0.0005)
    seq2 = rev_comp(fwd_proj)  # contig's own sequence
    contigs.append(
        SimContig("ctg2", seq2, [(0, 10000, cig2, False, (0, len(seq2)))])
    )

    # ctg3: split contig: two segments on chr2 separated by a 2000bp deletion
    # (wider than the 1000bp colinear-join threshold so the contig stays
    # split).  segB's recorded position MUST equal the slice start so the
    # BAM agrees with the ref FASTA — sequence-dependent passes (simplify
    # homology windows, GCI scoring) then run on homologous bases, not noise.
    segA = chr2[500:4000]
    segB = chr2[6000:9500]
    seqA, cigA_core = apply_edits(segA, rng, 0.001, 0.0005)
    seqB, cigB_core = apply_edits(segB, rng, 0.001, 0.0005)
    seq3 = np.concatenate([seqA, seqB])
    cigA = np.concatenate([cigA_core, cg.cigar((cg.S, len(seqB)))])
    cigB = np.concatenate([cg.cigar((cg.S, len(seqA))), cigB_core])
    contigs.append(
        SimContig(
            "ctg3",
            seq3,
            [
                (1, 500, cigA, True, (0, len(seqA))),
                (1, 6000, cigB, True, (len(seqA), len(seq3))),
            ],
        )
    )

    # ctg4: split contig with an INVERSION: forward first half, REVERSE
    # second half (chr1[16500:18300) fwd + chr1[18500:19800) rev) — covers
    # '-' SA strands, reverse supplementary patch-in, and reverse x split
    # read items, which no other contig exercises.
    ref_a4 = chr1[16500:18300]
    ref_b4 = chr1[18500:19800]
    seqA4, cigA4_core = apply_edits(ref_a4, rng, 0.001, 0.0005)
    derB4, cigB4_core = apply_edits(ref_b4, rng, 0.001, 0.0005)
    seqB4 = rev_comp(derB4)  # contig orientation of the inverted part
    seq4 = np.concatenate([seqA4, seqB4])
    cigA4 = np.concatenate([cigA4_core, cg.cigar((cg.S, len(seqB4)))])
    # rev record read = revcomp(seq4) = derB4 + revcomp(seqA4): aligned
    # prefix derB4 (ref-forward cigar), trailing soft clip of the A part
    cigB4 = np.concatenate([cigB4_core, cg.cigar((cg.S, len(seqA4)))])
    contigs.append(
        SimContig(
            "ctg4",
            seq4,
            [
                (0, 16500, cigA4, True, (0, len(seqA4))),
                (0, 18500, cigB4, False, (len(seqA4), len(seq4))),
            ],
        )
    )

    # --- contig-to-ref BAM (sorted by (tid, pos))
    contig_records = []
    for ci, contig in enumerate(contigs):
        sa_all = None
        if len(contig.segments) > 1:
            sa_all_parts = [
                _sa_segment_str(ref_header, t, p, c, f)
                for (t, p, c, f, _s) in contig.segments
            ]
        for si in range(len(contig.segments)):
            sa = None
            if len(contig.segments) > 1:
                sa = "".join(
                    s for j, s in enumerate(sa_all_parts) if j != si
                )
            contig_records.append(_contig_record(ref_header, contig, si, sa))
    contig_records.sort(key=lambda r: (r.tid, r.pos))
    contig_bam = os.path.join(tmpdir, "asm_to_ref.bam")
    with BamWriter(contig_bam, ref_header) as w:
        for r in contig_records:
            w.write(r)
    build_bai(contig_bam)

    # --- read-to-assembly BAM
    contig_header = BamHeader.from_refs(
        [(c.name, len(c.seq)) for c in contigs]
    )
    read_records = []
    read_infos = []
    ridx = 0
    for ci, contig in enumerate(contigs):
        clen = len(contig.seq)
        for _ in range(n_reads_per_contig):
            pos = int(rng.integers(0, max(clen - read_len, 1)))
            span = min(read_len, clen - pos)
            rseq, rcig = apply_edits(
                contig.seq[pos : pos + span], rng, read_snp_rate, read_indel_rate,
                eqx=False,
            )
            is_rev = rng.random() < 0.5
            qname = f"read{ridx:05d}"
            ridx += 1
            flag = FREVERSE if is_rev else 0
            seq = rseq if not is_rev else rev_comp(rseq)
            # BAM stores seq in ref(contig)-forward orientation = rseq; the
            # flag just records the sequencing strand.
            rec = BamRecord(
                qname=qname.encode(), flag=flag, tid=ci, pos=pos, mapq=int(rng.integers(0, 61)),
                cigar=rcig, seq=rseq,
                qual=rng.integers(10, 50, size=len(rseq)).astype(np.uint8),
            )
            rec.push_tag(b"NM", b"i", 0)
            read_records.append(rec)
            read_infos.append((qname, ci, pos, not is_rev, rcig))

    # one split read with two alignment segments on ctg3 linked by SA tags,
    # placed on either side of the contig's internal segment boundary
    half = 150
    boundary = contigs[2].segments[0][4][1]
    pos_a, pos_b = boundary - 200, boundary + 200
    sseq = np.concatenate(
        [contigs[2].seq[pos_a : pos_a + half], contigs[2].seq[pos_b : pos_b + half]]
    )
    scig_a = cg.cigar((cg.M, half), (cg.S, half))
    scig_b = cg.cigar((cg.S, half), (cg.M, half))
    sa_a = f"ctg3,{pos_a + 1},+,{cg.to_string(scig_a)},60,0;"
    sa_b = f"ctg3,{pos_b + 1},+,{cg.to_string(scig_b)},60,0;"
    prim = BamRecord(
        qname=b"split_read", flag=0, tid=2, pos=pos_a, mapq=60, cigar=scig_a,
        seq=sseq, qual=np.full(2 * half, 35, np.uint8),
    )
    prim.push_tag(b"SA", b"Z", sa_b)
    supp = BamRecord(
        qname=b"split_read", flag=FSUPPLEMENTARY, tid=2, pos=pos_b, mapq=60,
        cigar=scig_b, seq=sseq, qual=np.full(2 * half, 35, np.uint8),
    )
    supp.push_tag(b"SA", b"Z", sa_a)
    read_records.extend([prim, supp])

    read_records.sort(key=lambda r: (r.tid, r.pos))

    # trailing unmapped (unassembled) reads
    n_unmapped = 7
    for i in range(n_unmapped):
        ln = int(rng.integers(100, 200))
        read_records.append(
            BamRecord(
                qname=f"unmapped{i}".encode(), flag=FUNMAP, tid=-1, pos=-1,
                mapq=255, seq=rand_seq(rng, ln),
                qual=rng.integers(10, 50, size=ln).astype(np.uint8),
            )
        )

    read_bam = os.path.join(tmpdir, "read_to_asm.bam")
    with BamWriter(read_bam, contig_header) as w:
        for r in read_records:
            w.write(r)
    build_bai(read_bam)

    ref_fasta = os.path.join(tmpdir, "ref.fa")
    write_fasta(ref_fasta, ref_chroms)

    return Scenario(
        ref_fasta=ref_fasta,
        contig_bam=contig_bam,
        read_bam=read_bam,
        ref_chroms=ref_chroms,
        contigs=contigs,
        n_reads=ridx + 1,  # + split_read
        n_unmapped=n_unmapped,
        read_infos=read_infos,
    )
