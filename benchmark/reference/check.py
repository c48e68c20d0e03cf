"""The comparison that decides a run's ``correct``.

``Reference`` redoes phase 1 from the inputs and lifts a sample of reads on
the exact host path (``lift.process_read``); ``OutputScan`` reads the
records a call wrote.  Neither takes anything from the program but the
output BAMs it judges.  Records are compared whole, as decoded fields (the
BAM ``bin`` field aside): name, flag, position, MAPQ, CIGAR, sequence,
qualities and tags in order.
"""

from __future__ import annotations

import multiprocessing
import os
import struct

import numpy as np

from benchmark.reference.bam import FSECONDARY, FSUPPLEMENTARY, BamRecord
from benchmark.reference.bgzf import raw_records
from benchmark.reference.chrom_list import ChromList
from benchmark.reference.contig_scan import scan_contig_bam
from benchmark.reference.lift import process_read

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32


def read_fasta(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    out = {}
    for block in raw.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        arr = np.frombuffer(body, np.uint8)
        out[head.split()[0].decode()] = _UPPER[arr[(arr != 10) & (arr != 13)]]
    return out


def canonical(rec: BamRecord) -> tuple:
    """A record as the tuple of fields compared."""
    tags = tuple(
        (t, ty, v if not isinstance(v, tuple) else (v[0], bytes(np.asarray(v[1]).data)))
        for t, ty, v in rec.tags
    )
    return (rec.qname, rec.flag, rec.tid, rec.pos, rec.mapq,
            np.asarray(rec.cigar, np.int64).tobytes(), rec.mtid, rec.mpos,
            rec.tlen, np.asarray(rec.seq).tobytes(), np.asarray(rec.qual).tobytes(),
            tags)


def _name(raw) -> bytes:
    return bytes(raw[32:32 + raw[8] - 1])


class OutputScan:
    """One output BAM: its record count, its count of records that are
    neither supplementary nor secondary, and the raw records of the wanted
    read names."""

    def __init__(self, path: str, wanted: set[bytes], threads: int = 8):
        self.n_records = self.n_primary = 0
        self.found: dict[bytes, list[bytes]] = {}
        for raw in raw_records(path, threads):
            self.n_records += 1
            if not struct.unpack_from("<H", raw, 14)[0] & (FSUPPLEMENTARY | FSECONDARY):
                self.n_primary += 1
            name = _name(raw)
            if name in wanted:
                self.found.setdefault(name, []).append(bytes(raw))

    def records(self, name: bytes) -> list[tuple]:
        return sorted(canonical(BamRecord.decode(r)) for r in self.found.get(name, []))


_LIFTING: dict = {}  # the Reference of a worker of ``lift_all``


def _lifter(paths: tuple[str, str, str]) -> None:
    _LIFTING["ref"] = Reference(*paths)


def _lift_chunk(job: tuple[list[bytes], bool]) -> list[tuple]:
    raws, control = job
    return [r for raw in raws for r in _LIFTING["ref"].lift_raw(raw, control)]


class Reference:
    """Phase 1 redone from the inputs, and the expected records of a sample
    of the reads: ``expected[name] = (remapped records, unassembled records)``,
    each a sorted list of ``canonical`` tuples."""

    def __init__(self, fasta: str, contig_bam: str, reads_bam: str):
        self.ref_chrom_list = ChromList.from_bam_filename(contig_bam)
        self.contig_list = ChromList.from_bam_filename(reads_bam)
        genome = read_fasta(fasta)
        self.reference = [genome[c.label] for c in self.ref_chrom_list.data]
        self.info = scan_contig_bam(contig_bam, self.ref_chrom_list,
                                    self.contig_list)
        self.paths = (fasta, contig_bam, reads_bam)
        self.reads_bam = reads_bam

    def expected(self, names: set[bytes], control: bool = False) -> dict:
        """The exact host path's records for ``names``; ``control`` lifts
        them without the indel normalisation instead (``lift.process_read``)."""
        out = {}
        for raw in raw_records(self.reads_bam):
            name = _name(raw)
            if name not in names:
                continue
            rec = BamRecord.decode(bytes(raw))
            if rec.is_unmapped():
                out[name] = ([], [canonical(rec)])
                continue
            if rec.is_supplementary() or rec.is_secondary():
                continue
            lifted = process_read(rec, self.reference, self.ref_chrom_list,
                                  self.contig_list, self.info, False,
                                  control=control)
            out[name] = (
                sorted(canonical(BamRecord.decode(r.encode())) for r in lifted),
                [],
            )
        return out

    def lift_raw(self, raw: bytes, control: bool = False) -> list[tuple]:
        """One input record as the program's outputs would hold it: a list of
        ``(tid, pos, end, raw)``, ``tid`` -1 for the unassembled output."""
        rec = BamRecord.decode(raw)
        if rec.is_unmapped():
            return [(-1, -1, -1, raw)]
        if rec.is_supplementary() or rec.is_secondary():
            return []
        return [(r.tid, r.pos, r.alignment_end(), r.encode())
                for r in process_read(rec, self.reference, self.ref_chrom_list,
                                      self.contig_list, self.info, False,
                                      control=control)]

    def lift_all(self, control: bool = False, workers: int | None = None):
        """Every read of the BAM lifted, on ``workers`` processes of their
        own (each redoes phase 1): (remapped records, unassembled records),
        each a list of ``(tid, pos, end, raw)``."""
        raws = [bytes(r) for r in raw_records(self.reads_bam)]
        jobs = [(raws[i:i + 256], control) for i in range(0, len(raws), 256)]
        n = workers or min(8, os.cpu_count() or 1, len(jobs))
        pool = multiprocessing.get_context("spawn").Pool(n, _lifter, (self.paths,))
        try:
            lifted = [r for part in pool.map(_lift_chunk, jobs) for r in part]
        finally:
            pool.close()
            pool.join()
        return ([r for r in lifted if r[0] >= 0], [r for r in lifted if r[0] < 0])
