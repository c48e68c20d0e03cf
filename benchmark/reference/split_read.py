"""Split-read (SA tag) parsing into sequencing-order segments.

Behavioral equivalent of the reference split-read layer
(reference lib/rust-vc-utils/src/bam_utils/split_read.rs:15-155 and
bam_utils/aux/sa_tag_parser.rs:25-59).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.bam import BamRecord
from benchmark.reference import cigar as cg
from benchmark.reference.chrom_list import ChromList


@dataclass
class SplitReadSegment:
    """One raw SA-tag segment (sa_tag_parser.rs:4-21)."""

    rname: str
    pos: int  # zero-indexed
    cigar: np.ndarray
    is_fwd_strand: bool
    mapq: int
    nm: int


def parse_sa_segment(seg: str) -> SplitReadSegment:
    """(sa_tag_parser.rs:25-46)

    Field splitting mirrors Rust ``split_terminator(',')``: exactly ONE
    trailing empty field (a trailing comma) is tolerated; the MAPQ field is
    a u8 there, so values outside [0, 255] are a hard error."""
    fields = seg.split(",")
    if fields and fields[-1] == "":
        fields.pop()
    if len(fields) != 6:
        raise ValueError(f"Unexpected segment in bam SA tag: {seg}")
    mapq = int(fields[4])
    if not 0 <= mapq <= 255:
        raise ValueError(f"Unexpected segment in bam SA tag: {seg}")
    return SplitReadSegment(
        rname=fields[0],
        pos=int(fields[1]) - 1,
        is_fwd_strand=fields[2] == "+",
        cigar=cg.from_string(fields[3]),
        mapq=mapq,
        nm=int(fields[5]),
    )


def parse_sa_aux_val(sa_aux_val: str) -> list[SplitReadSegment]:
    """(sa_tag_parser.rs:54-59)

    Rust ``split_terminator(';')`` drops only the TRAILING empty segment;
    an interior empty (doubled ';') reaches the segment parser and fails —
    a corrupt tag must abort, not silently lift (panic parity, SURVEY 3.5).
    """
    segs = sa_aux_val.split(";")
    if segs and segs[-1] == "":
        segs.pop()
    return [parse_sa_segment(s) for s in segs]


@dataclass
class SeqOrderSplitReadSegment:
    """Split segment with read coordinates normalized to sequencing order
    (split_read.rs:15-49)."""

    seq_order_read_start: int
    seq_order_read_end: int
    chrom_index: int
    pos: int
    is_fwd_strand: bool
    cigar: np.ndarray = field(repr=False)
    mapq: int
    from_primary_bam_record: bool

    def short_display(self) -> str:
        end = self.pos + cg.get_cigar_ref_offset(self.cigar)
        return (
            f"seq_order_read_start/end: {self.seq_order_read_start}/"
            f"{self.seq_order_read_end} ref_segment: {self.chrom_index}:"
            f"{self.pos}-{end} fwd: {str(self.is_fwd_strand).lower()} "
            f"mapq: {self.mapq}"
        )


def _seq_order_read_pos(
    read_start: int, read_end: int, read_size: int, is_fwd_strand: bool
) -> tuple[int, int]:
    """Strand flip to sequencing-order coordinates (split_read.rs:73-84)."""
    if is_fwd_strand:
        return read_start, read_end
    return read_size - read_end, read_size - read_start


def get_seq_order_read_split_segments(
    chrom_list: ChromList, record: BamRecord
) -> list[SeqOrderSplitReadSegment]:
    """Parse the primary record + its SA tag into ordered split segments
    (split_read.rs:56-155).  Raises on malformed/unaligned SA segments and
    unknown chromosomes, mirroring the reference's hard panics."""
    read_start, read_end, read_size = cg.get_read_clip_positions(record.cigar, False)
    so_start, so_end = _seq_order_read_pos(
        read_start, read_end, read_size, not record.is_reverse()
    )
    segments = [
        SeqOrderSplitReadSegment(
            seq_order_read_start=so_start,
            seq_order_read_end=so_end,
            chrom_index=record.tid,
            pos=record.pos,
            is_fwd_strand=not record.is_reverse(),
            cigar=record.cigar,
            mapq=record.mapq,
            from_primary_bam_record=True,
        )
    ]

    sa_val = record.get_string_tag(b"SA")
    if sa_val is not None:
        qname = record.qname.decode()
        for i, sa in enumerate(parse_sa_aux_val(sa_val)):
            if not cg.has_aligned_segments(sa.cigar):
                raise ValueError(
                    f"Bam record split segment id unaligned in read {qname}"
                )
            r_start, r_end, r_size = cg.get_read_clip_positions(sa.cigar, False)
            if r_size != read_size:
                raise ValueError(
                    f"Inconsistent split read sizes in read {qname}: "
                    f"{r_size} != {read_size}"
                )
            so_start, so_end = _seq_order_read_pos(
                r_start, r_end, r_size, sa.is_fwd_strand
            )
            chrom_index = chrom_list.label_to_index.get(sa.rname)
            if chrom_index is None:
                raise ValueError(
                    f"In read '{qname}', the SA aux tag describes a split read "
                    f"mapped to {sa.rname}:{sa.pos} (in segment {i}), which is "
                    f"not found in the input reference fasta"
                )
            segments.append(
                SeqOrderSplitReadSegment(
                    seq_order_read_start=so_start,
                    seq_order_read_end=so_end,
                    chrom_index=chrom_index,
                    pos=sa.pos,
                    is_fwd_strand=sa.is_fwd_strand,
                    cigar=sa.cigar,
                    mapq=sa.mapq,
                    from_primary_bam_record=False,
                )
            )
        segments.sort(key=lambda s: s.seq_order_read_start)

    for s in segments:
        if s.seq_order_read_start >= s.seq_order_read_end:
            raise ValueError(
                "Can't parse consistent split read information from SA tag "
                f"format in read: {record.qname.decode()}"
            )
    return segments
