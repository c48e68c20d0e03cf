"""Phase 1: scan the assembly-to-reference BAM into the contig mapping index.

A frozen copy of the port's exact host path (reference
src/contig_alignment_scanner/mod.rs:25-459 plus its post-pass filters), as
one sequential Python walk: no native scanner, no index file, no target
region.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference import cigar as cg
from benchmark.reference.blockmap import BlockMap, build_block_map
from benchmark.reference.clip import clip_alignment_read_edges
from benchmark.reference.score import get_gap_compressed_identity_no_align_match
from benchmark.reference.seq import rev_comp
from benchmark.reference.split_read import (
    SeqOrderSplitReadSegment,
    get_seq_order_read_split_segments,
)
from benchmark.reference.chrom_list import ChromList
from benchmark.reference.bam import BamRecord
from benchmark.reference.bgzf import raw_records
from benchmark.reference.int_range import IntRange

logger = logging.getLogger("benchmark.reference")


@dataclass
class ContigMappingSegmentInfo:
    """(contig_alignment_scanner/mod.rs:25-32)"""

    seq_order_segment: SeqOrderSplitReadSegment
    contig_to_ref_map: BlockMap = field(default_factory=BlockMap)


@dataclass
class ContigMappingInfo:
    """(contig_alignment_scanner/mod.rs:37-47)"""

    qname: str = ""
    ordered_contig_segment_info: list[ContigMappingSegmentInfo] = field(
        default_factory=list
    )
    rev_contig_seq: np.ndarray | None = None


AllContigMappingInfo = list  # list[ContigMappingInfo], indexed by contig id


def _split_read_key(seg: SeqOrderSplitReadSegment) -> tuple:
    """Supplementary-record match key (mod.rs:49-58): exact CIGARs must be taken
    from supplementary records because minimap2 SA-tag CIGARs for contigs are
    approximate (docs/methods.md:9-12)."""
    read_start, read_end, read_size = cg.get_read_clip_positions(seg.cigar, False)
    return (
        seg.chrom_index,
        seg.pos,
        seg.is_fwd_strand,
        read_start,
        read_size - read_end,
    )


def _add_primary_read(
    ref_chrom_list: ChromList, record
) -> ContigMappingInfo:
    """(mod.rs:91-133)"""
    ordered = get_seq_order_read_split_segments(ref_chrom_list, record)
    infos = []
    need_rev = False
    for seg in ordered:
        if seg.from_primary_bam_record:
            bm = build_block_map(seg.pos, seg.cigar, False)
        else:
            bm = BlockMap()
        infos.append(ContigMappingSegmentInfo(seg, bm))
        need_rev = need_rev or not seg.is_fwd_strand
    rev_seq = None
    if need_rev:
        # The stored sequence must be the reverse-strand contig sequence; a
        # forward-mapped primary record needs rev-comp (mod.rs:113-125).
        seq = record.seq
        rev_seq = seq.copy() if record.is_reverse() else rev_comp(seq)
    return ContigMappingInfo(
        qname=record.qname.decode(),
        ordered_contig_segment_info=infos,
        rev_contig_seq=rev_seq,
    )


_INDEX_VERSION = 1

def scan_contig_bam(
    bam_path: str,
    ref_chrom_list: ChromList,
    assembly_contig_list: ChromList,
    max_join_gap: int | None = None,
) -> AllContigMappingInfo:
    """Phase 1 (mod.rs:290-459) as one sequential walk over the records,
    for a whole-genome run (no target region)."""
    result: list[ContigMappingInfo] = [
        ContigMappingInfo() for _ in range(len(assembly_contig_list))
    ]
    supp_cigars: list[dict] = [dict() for _ in range(len(assembly_contig_list))]
    for raw in raw_records(bam_path):
        record = BamRecord.decode(bytes(raw), lazy=True)
        if record.is_unmapped() or record.is_secondary():
            continue
        qname = record.qname.decode()
        contig_id = assembly_contig_list.label_to_index[qname]
        if not record.is_supplementary():
            result[contig_id] = _add_primary_read(ref_chrom_list, record)
            continue
        key = (record.tid, record.pos, not record.is_reverse(),
               *_clip_pair(record.cigar))
        if key in supp_cigars[contig_id]:
            raise ValueError(
                "Can't uniquely identify split read alignment info in "
                f"contig '{qname}'"
            )
        supp_cigars[contig_id][key] = (
            record.cigar, build_block_map(record.pos, record.cigar, False)
        )

    # Patch exact supplementary CIGARs into the non-primary segments
    # (mod.rs:360-439); a missing one is an error in a whole-genome run.
    for contig_index, info in enumerate(result):
        for seg_info in info.ordered_contig_segment_info:
            seg = seg_info.seq_order_segment
            if seg.from_primary_bam_record:
                continue
            found = supp_cigars[contig_index].get(_split_read_key(seg))
            if found is None:
                raise ValueError(
                    "Can't find supplementary alignment record corresponding "
                    "to segment reported in SA tag for contig "
                    f"'{assembly_contig_list.data[contig_index].label}'"
                )
            seg.cigar = found[0]
            seg_info.contig_to_ref_map = found[1]

    clip_repeated_contig_matches(result)
    join_colinear_contig_segments(result, max_join_gap)
    return result

def _clip_pair(cigar: np.ndarray) -> tuple[int, int]:
    read_start, read_end, read_size = cg.get_read_clip_positions(cigar, False)
    return read_start, read_size - read_end


# ---------------------------------------------------------------------------
# Target-region filter (non_targeted_segment_filter.rs:7-39)
# ---------------------------------------------------------------------------

def _seg_gap_compressed_identity(
    qname: str, seg: SeqOrderSplitReadSegment, isec: IntRange
) -> float:
    """(contig_repeated_match_trimmer.rs:18-49)"""
    read_len = cg.get_cigar_read_offset(seg.cigar, False)
    rng = isec if seg.is_fwd_strand else isec.get_reverse_range(read_len)
    clipped, _ = clip_alignment_read_edges(
        seg.cigar, rng.start, read_len - rng.end
    )
    try:
        return get_gap_compressed_identity_no_align_match(clipped)
    except ValueError as e:
        raise ValueError(
            "Error generating gap-compressed identity for overlapping split "
            f"read segment in assembly contig '{qname}': {e}"
        ) from e


def clip_seg_isec_range(seg: SeqOrderSplitReadSegment, isec: IntRange) -> bool:
    """Remove the intersection range from a split segment; True when the whole
    segment is clipped away (contig_repeated_match_trimmer.rs:54-112)."""
    is_clipping_seq_order_prefix = isec.start == seg.seq_order_read_start
    is_clipping_prefix = is_clipping_seq_order_prefix ^ (not seg.is_fwd_strand)

    read_len = cg.get_cigar_read_offset(seg.cigar, False)
    rng = isec if seg.is_fwd_strand else isec.get_reverse_range(read_len)

    if is_clipping_prefix:
        min_left, min_right = rng.end, 0
    else:
        min_left, min_right = 0, read_len - rng.start
    new_cigar, ref_shift = clip_alignment_read_edges(seg.cigar, min_left, min_right)
    seg.cigar = new_cigar
    seg.pos += ref_shift

    left_pos, right_pos, _ = cg.get_read_clip_positions(seg.cigar, False)
    if left_pos >= right_pos:
        return True

    # The actual clip can exceed the requested minimum (rs:84-96).
    rng = IntRange(rng.start, rng.end)
    if is_clipping_prefix:
        rng.end = left_pos
    else:
        rng.start = right_pos
    so_rng = rng if seg.is_fwd_strand else rng.get_reverse_range(read_len)
    if is_clipping_seq_order_prefix:
        seg.seq_order_read_start = so_rng.end
    else:
        seg.seq_order_read_end = so_rng.start
    return False


def _clip_seg_info_isec_range(
    seg_info: ContigMappingSegmentInfo, isec: IntRange
) -> bool:
    """(contig_repeated_match_trimmer.rs:117-136)"""
    if clip_seg_isec_range(seg_info.seq_order_segment, isec):
        return True
    seg = seg_info.seq_order_segment
    seg_info.contig_to_ref_map = build_block_map(seg.pos, seg.cigar, False)
    return False


def _get_seg_clip_info(
    info: ContigMappingInfo, i1: int, i2: int
) -> tuple[IntRange, int] | None:
    """(contig_repeated_match_trimmer.rs:144-204)"""
    seg1 = info.ordered_contig_segment_info[i1].seq_order_segment
    seg2 = info.ordered_contig_segment_info[i2].seq_order_segment
    if seg1.seq_order_read_end <= seg2.seq_order_read_start:
        return None
    isec = IntRange(seg2.seq_order_read_start, seg1.seq_order_read_end)
    gci1 = _seg_gap_compressed_identity(info.qname, seg1, isec)
    gci2 = _seg_gap_compressed_identity(info.qname, seg2, isec)
    # Winner: higher gap-compressed identity, MAPQ breaks ties (rs:183-189).
    if gci2 > gci1 or (gci2 == gci1 and seg2.mapq > seg1.mapq):
        clip_index = i1
    else:
        clip_index = i2
    return isec, clip_index


def clip_repeated_contig_matches(result: AllContigMappingInfo) -> None:
    """(contig_repeated_match_trimmer.rs:214-303)"""
    logger.info(
        "Clipping repeated contig matches at split alignment segment boundaries"
    )
    segments_clipped = 0
    for info in result:
        segs = info.ordered_contig_segment_info
        if not segs:
            continue
        n = len(segs)
        eliminated = [False] * n
        for i1 in range(n):
            for i2 in range(i1 + 1, n):
                if eliminated[i1] or eliminated[i2]:
                    continue
                got = _get_seg_clip_info(info, i1, i2)
                if got is None:
                    break
                isec, clip_index = got
                if _clip_seg_info_isec_range(segs[clip_index], isec):
                    eliminated[clip_index] = True
                segments_clipped += 1
        info.ordered_contig_segment_info = [
            s for s, e in zip(segs, eliminated) if not e
        ]
    logger.info(f"Clipped {segments_clipped} repeated contig match regions")


# ---------------------------------------------------------------------------
# Colinear segment joiner (contig_colinear_segment_joiner.rs:15-186)
# ---------------------------------------------------------------------------

MAX_SEGMENT_REF_GAP = 1000  # (joiner.rs:37)


def _seg_ref_gap(seg1: SeqOrderSplitReadSegment, seg2: SeqOrderSplitReadSegment) -> int:
    """(joiner.rs:15-23)"""
    if seg1.is_fwd_strand:
        return seg2.pos - (seg1.pos + cg.get_cigar_ref_offset(seg1.cigar))
    return seg1.pos - (seg2.pos + cg.get_cigar_ref_offset(seg2.cigar))


def _are_segments_joinable(
    seg1: SeqOrderSplitReadSegment,
    seg2: SeqOrderSplitReadSegment,
    max_gap: int,
) -> bool:
    """(joiner.rs:27-49)"""
    if seg1.chrom_index != seg2.chrom_index or seg1.is_fwd_strand != seg2.is_fwd_strand:
        return False
    gap = _seg_ref_gap(seg1, seg2)
    if gap < 0 or gap > max_gap:
        return False
    return seg1.mapq == seg2.mapq


def _join_cigars(a: np.ndarray, b: np.ndarray, ins: int, dele: int) -> np.ndarray:
    """Splice the Z-drop gap as Ins+Del between clip-stripped cigars
    (joiner.rs:79-94)."""
    parts = [cg.strip_trailing_clip(a)]
    if ins > 0:
        parts.append(cg.cigar((cg.I, ins)))
    if dele > 0:
        parts.append(cg.cigar((cg.D, dele)))
    parts.append(cg.strip_leading_clip(b))
    return np.concatenate([p for p in parts if len(p)])


def _join_segments(
    seg_info1: ContigMappingSegmentInfo, seg_info2: ContigMappingSegmentInfo
) -> None:
    """(joiner.rs:57-122)"""
    seg1 = seg_info1.seq_order_segment
    seg2 = seg_info2.seq_order_segment
    join_del = _seg_ref_gap(seg1, seg2)
    assert join_del >= 0
    assert seg2.seq_order_read_start >= seg1.seq_order_read_end
    join_ins = seg2.seq_order_read_start - seg1.seq_order_read_end

    if seg1.is_fwd_strand:
        seg1.cigar = _join_cigars(seg1.cigar, seg2.cigar, join_ins, join_del)
    else:
        # Reverse-strand pairs join in flipped order (joiner.rs:103-113).
        seg1.cigar = _join_cigars(seg2.cigar, seg1.cigar, join_ins, join_del)
        seg1.pos = seg2.pos
    seg1.seq_order_read_end = seg2.seq_order_read_end
    seg_info1.contig_to_ref_map = build_block_map(seg1.pos, seg1.cigar, False)


def join_colinear_contig_segments(
    result: AllContigMappingInfo, max_join_gap: int | None = None
) -> None:
    """(joiner.rs:124-186); ``max_join_gap`` defaults to the reference's
    hard-coded 1000 (joiner.rs:37), surfaced as config per SURVEY section 5."""
    max_gap = MAX_SEGMENT_REF_GAP if max_join_gap is None else max_join_gap
    logger.info("Joining colinear split alignment segments in each assembly contig")
    segments_joined = 0
    for info in result:
        if not info.ordered_contig_segment_info:
            continue
        old = info.ordered_contig_segment_info
        new: list[ContigMappingSegmentInfo] = []
        for segment in old:
            if not new:
                new.append(segment)
                continue
            last = new[-1]
            assert (
                segment.seq_order_segment.seq_order_read_start
                >= last.seq_order_segment.seq_order_read_end
            ), (
                f"Incomplete repeat trimming on qname: {info.qname} "
                f"Segment1: {last.seq_order_segment.short_display()} "
                f"Segment2: {segment.seq_order_segment.short_display()}"
            )
            if _are_segments_joinable(
                last.seq_order_segment, segment.seq_order_segment, max_gap
            ):
                _join_segments(last, segment)
                segments_joined += 1
            else:
                new.append(segment)
        info.ordered_contig_segment_info = new
    logger.info(f"Joined {segments_joined} colinear segments")
