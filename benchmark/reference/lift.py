"""Phase 2 of one read on the exact host path: a frozen copy of the port's
``pipeline/read_scan.py`` per-read functions (reference
src/read_alignment_scanner.rs:24-479).

``process_read(..., control=True)`` is the benchmark's control: the same
lift without its indel normalisation (no left shift of the indels of a read
on a reverse contig, no simplification of indel clusters), a result that
breaks the configuration's guarantee that every record equals the exact
host path's.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg
from benchmark.reference.bam import FREVERSE, BamRecord
from benchmark.reference.chrom_list import ChromList
from benchmark.reference.contig_scan import (
    AllContigMappingInfo,
    ContigMappingSegmentInfo,
)
from benchmark.reference.int_range import IntRange
from benchmark.reference.liftover import liftover_read_alignment
from benchmark.reference.seq import rev_comp
from benchmark.reference.shift import left_shift_indels
from benchmark.reference.simplify import simplify_alignment_indels
from benchmark.reference.split_read import (
    SeqOrderSplitReadSegment,
    get_seq_order_read_split_segments,
)

NM_TAG, SA_TAG, PS_TAG, ZM_TAG = b"NM", b"SA", b"PS", b"ZM"


def get_contig_split_segments_from_read_mapping(
    read_segment: SeqOrderSplitReadSegment,
    contig_segments: list[ContigMappingSegmentInfo],
) -> list[int]:
    """Contig split segments whose contig-coordinate range intersects the read
    segment's alignment span (read_alignment_scanner.rs:80-103)."""
    out = []
    read_range = IntRange(
        read_segment.pos,
        read_segment.pos + cg.get_cigar_ref_offset(read_segment.cigar),
    )
    for i, seg_info in enumerate(contig_segments):
        seg = seg_info.seq_order_segment
        seg_range = IntRange(seg.seq_order_read_start, seg.seq_order_read_end)
        if seg_range.intersect_range(read_range):
            out.append(i)
    return out


def clone_record(record: BamRecord) -> BamRecord:
    """Copy minus the tags that liftover invalidates or regenerates
    (read_alignment_scanner.rs:105-117)."""
    rec = BamRecord(
        qname=record.qname,
        flag=record.flag,
        tid=record.tid,
        pos=record.pos,
        mapq=record.mapq,
        cigar=record.cigar,
        mtid=record.mtid,
        mpos=record.mpos,
        tlen=record.tlen,
        seq=record.seq,
        qual=record.qual,
        tags=[t for t in record.tags if t[0] not in (NM_TAG, SA_TAG, PS_TAG, ZM_TAG)],
    )
    return rec


def reverse_alignment_seq_and_qual(record: BamRecord) -> None:
    """Flip the reverse flag, revcomp seq, reverse qual
    (read_alignment_scanner.rs:125-133)."""
    record.flag ^= FREVERSE
    record.seq = rev_comp(record.seq)
    record.qual = record.qual[::-1].copy()
    record.raw = None


def get_liftover_alignment_for_read_and_contig_segment(
    reference: list[np.ndarray],
    contig_list: ChromList,
    record: BamRecord,
    read_segment: SeqOrderSplitReadSegment,
    contig_segment_index: int,
    seg_info: ContigMappingSegmentInfo,
    rev_contig_seq: np.ndarray | None,
    control: bool = False,
) -> BamRecord | None:
    """Lift one (read segment x contig segment) pair into a remapped record
    (read_alignment_scanner.rs:136-288) — the host/exact path."""
    contig_to_ref_map = seg_info.contig_to_ref_map
    contig_is_fwd = seg_info.seq_order_segment.is_fwd_strand

    read_segment_changes_strand = record.is_reverse() == read_segment.is_fwd_strand
    need_flip = (not contig_is_fwd) ^ read_segment_changes_strand

    if contig_is_fwd:
        pos_on_ref_strand = read_segment.pos
        cigar_on_ref_strand = read_segment.cigar
    else:
        contig_length = contig_list.data[read_segment.chrom_index].length
        seg_end = read_segment.pos + cg.get_cigar_ref_offset(read_segment.cigar)
        rev_pos = contig_length - seg_end
        rev_cigar = cg.reverse_cigar(read_segment.cigar)
        read_seq = rev_comp(record.seq) if need_flip else record.seq
        # Re-left-shift indels against the reversed contig so the lifted
        # alignment comes out left-shifted (docs/methods.md:37-39).
        if control:
            pos_on_ref_strand, cigar_on_ref_strand = rev_pos, rev_cigar
        else:
            pos_on_ref_strand, cigar_on_ref_strand = left_shift_indels(
                rev_pos, rev_cigar, rev_contig_seq, read_seq
            )

    lifted = liftover_read_alignment(
        contig_to_ref_map, pos_on_ref_strand, cigar_on_ref_strand
    )
    if lifted is None:
        return None
    ref2_pos_orig, ref2_cigar_orig = lifted

    # Lifted CIGAR must preserve the read length
    # (read_alignment_scanner.rs:204-229 panics on violation).
    cigar_read_len = cg.get_cigar_read_offset(ref2_cigar_orig, False)
    if record.seq_len() != cigar_read_len:
        raise AssertionError(
            f"Failed to remap qname: {record.qname.decode()}: seq len "
            f"{record.seq_len()} != lifted cigar read len {cigar_read_len}"
        )

    chrom_index = seg_info.seq_order_segment.chrom_index
    read_seq = rev_comp(record.seq) if need_flip else record.seq
    if control:
        ref2_pos, ref2_cigar = ref2_pos_orig, ref2_cigar_orig
    else:
        ref2_pos, ref2_cigar = simplify_alignment_indels(
            ref2_pos_orig, ref2_cigar_orig, reference[chrom_index], read_seq
        )

    return finish_lifted_record(
        record,
        contig_list,
        read_segment,
        contig_segment_index,
        seg_info,
        chrom_index,
        ref2_pos,
        ref2_cigar,
        need_flip,
    )


def finish_lifted_record(
    record: BamRecord,
    contig_list: ChromList,
    read_segment: SeqOrderSplitReadSegment,
    contig_segment_index: int,
    seg_info: ContigMappingSegmentInfo,
    chrom_index: int,
    ref2_pos: int,
    ref2_cigar: np.ndarray,
    need_flip: bool,
) -> BamRecord:
    """Build the output record: tid/pos/cigar, MAPQ adoption, PS/ZM tags,
    strand flip, supplementary marking (read_alignment_scanner.rs:245-284)."""
    contig_is_fwd = seg_info.seq_order_segment.is_fwd_strand
    rec = clone_record(record)
    rec.tid = chrom_index
    contig_mapq = seg_info.seq_order_segment.mapq
    original_mapq = rec.mapq
    rec.mapq = contig_mapq
    contig_name = contig_list.data[read_segment.chrom_index].label
    ps_tag = (
        f"{contig_name}_split{contig_segment_index}{'+' if contig_is_fwd else '-'}"
    )
    rec.push_tag(PS_TAG, b"Z", ps_tag)
    rec.push_tag(ZM_TAG, b"C", original_mapq)
    rec.pos = int(ref2_pos)
    rec.cigar = ref2_cigar
    if need_flip:
        reverse_alignment_seq_and_qual(rec)
    rec.set_supplementary()
    return rec


def get_sa_tag_segment(chrom_list: ChromList, record: BamRecord) -> str:
    """One SA-tag segment (read_alignment_scanner.rs:292-301); NM hardcoded 0."""
    chrom = chrom_list.data[record.tid].label
    schar = "-" if record.is_reverse() else "+"
    return (
        f"{chrom},{record.pos + 1},{schar},{cg.to_string(record.cigar)},"
        f"{record.mapq},0;"
    )


def finish_remapped_alignment_set(
    ref_chrom_list: ChromList,
    orig_primary_record: BamRecord,
    remapped_records: list[BamRecord],
    is_target_region: bool,
) -> list[BamRecord]:
    """Primary selection + SA tag regeneration, or unmapped record emission
    (read_alignment_scanner.rs:310-366)."""
    if not remapped_records:
        if is_target_region:
            return []
        rec = clone_record(orig_primary_record)
        rec.set_unmapped()
        rec.unset_supplementary()
        rec.cigar = cg.EMPTY.copy()
        rec.mapq = 255
        rec.tid = -1
        rec.pos = -1
        if rec.is_reverse():
            reverse_alignment_seq_and_qual(rec)
        return [rec]

    # Primary = highest MAPQ, first in read order on ties
    # (read_alignment_scanner.rs:338-346, docs/methods.md:41-46).
    primary = 0
    for i in range(1, len(remapped_records)):
        if remapped_records[primary].mapq < remapped_records[i].mapq:
            primary = i
    remapped_records[primary].unset_supplementary()

    if len(remapped_records) > 1:
        sa_parts = [get_sa_tag_segment(ref_chrom_list, r) for r in remapped_records]
        for i, rec in enumerate(remapped_records):
            aux = "".join(p for j, p in enumerate(sa_parts) if j != i)
            if aux:
                rec.push_tag(SA_TAG, b"Z", aux)
    return remapped_records


def process_read(
    record: BamRecord,
    reference: list[np.ndarray],
    ref_chrom_list: ChromList,
    contig_list: ChromList,
    all_contig_mapping_info: AllContigMappingInfo,
    is_target_region: bool,
    control: bool = False,
) -> list[BamRecord]:
    """Full liftover of one primary read record
    (read_alignment_scanner.rs:419-479)."""
    remapped: list[BamRecord] = []
    ordered_splits = get_seq_order_read_split_segments(contig_list, record)
    for read_segment in ordered_splits:
        contig_info = all_contig_mapping_info[read_segment.chrom_index]
        contig_segments = contig_info.ordered_contig_segment_info
        for ci in get_contig_split_segments_from_read_mapping(
            read_segment, contig_segments
        ):
            rec = get_liftover_alignment_for_read_and_contig_segment(
                reference,
                contig_list,
                record,
                read_segment,
                ci,
                contig_segments[ci],
                contig_info.rev_contig_seq,
                control,
            )
            if rec is not None:
                remapped.append(rec)
    return finish_remapped_alignment_set(
        ref_chrom_list, record, remapped, is_target_region
    )
