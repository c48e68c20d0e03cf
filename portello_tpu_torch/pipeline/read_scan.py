"""Phase 2: stream reads through the contig index, lift, and emit BAMs.

Behavioral equivalent of the reference read scanner + liftover driver
(reference src/read_alignment_scanner.rs:24-661).  The per-read liftover work
is expressed as independent work items; the host engine here evaluates them
with the exact ``portello_tpu_torch.ops`` oracle, and the device engine
(``portello_tpu_torch.models.pipeline_model``) evaluates batches of them with the
JAX kernels, falling back to this host path for flagged items.
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from portello_tpu_torch._version import PROGRAM_NAME, PROGRAM_VERSION
from portello_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter
from portello_tpu_torch.ops import cigar as cg
from portello_tpu_torch.ops.liftover import liftover_read_alignment
from portello_tpu_torch.ops.seq import rev_comp
from portello_tpu_torch.ops.shift import left_shift_indels
from portello_tpu_torch.ops.simplify import simplify_alignment_indels
from portello_tpu_torch.pipeline.contig_scan import (
    AllContigMappingInfo,
    ContigMappingSegmentInfo,
)
from portello_tpu_torch.pipeline.split_read import (
    SeqOrderSplitReadSegment,
    get_seq_order_read_split_segments,
)
from portello_tpu_torch.utils.chrom_list import ChromList
from portello_tpu_torch.utils.int_range import IntRange

logger = logging.getLogger("portello-tpu")

NM_TAG, SA_TAG, PS_TAG, ZM_TAG = b"NM", b"SA", b"PS", b"ZM"


def get_alignment_file_header(chrom_list: ChromList, cmdline: str) -> BamHeader:
    """Output header: HD + SQ lines + PG with the full command line
    (read_alignment_scanner.rs:35-59)."""
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for info in chrom_list.data:
        lines.append(f"@SQ\tSN:{info.label}\tLN:{info.length}")
    lines.append(
        f"@PG\tPN:{PROGRAM_NAME}\tID:{PROGRAM_NAME}-{PROGRAM_VERSION}"
        f"\tVN:{PROGRAM_VERSION}\tCL:{cmdline}"
    )
    text = ("\n".join(lines) + "\n").encode()
    return BamHeader(text=text, refs=[(c.label, c.length) for c in chrom_list.data])


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
    from portello_tpu_torch.io.bam import FREVERSE

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
            )
            if rec is not None:
                remapped.append(rec)
    return finish_remapped_alignment_set(
        ref_chrom_list, record, remapped, is_target_region
    )


def scan_and_remap_reads(
    read_to_assembly_bam: str,
    remapped_read_output: str,
    unassembled_read_output: str,
    reference: list[np.ndarray],
    ref_chrom_list: ChromList,
    all_contig_mapping_info: AllContigMappingInfo,
    is_target_region: bool,
    cmdline: str = "",
    engine=None,
    thread_count: int = 1,
    shard_plan=None,
) -> None:
    """Stream the read-to-assembly BAM: copy unmapped reads to the unassembled
    output, lift everything else (read_alignment_scanner.rs:566-661).

    ``engine``: optional device batch engine
    (portello_tpu_torch.models.pipeline_model.DeviceEngine); None = host oracle.
    """
    logger.info(
        f"Processing read-to-contig alignment file '{read_to_assembly_bam}'"
    )
    contig_list = ChromList.from_bam_filename(read_to_assembly_bam)
    header = get_alignment_file_header(ref_chrom_list, cmdline)

    if engine is not None:
        engine.set_ref_chrom_list(ref_chrom_list)
        engine.is_target_region = is_target_region

    # BGZF writer thread count mirrors the reference's max(1, threads/2)
    # (read_alignment_scanner.rs:589); stdout output stays uncompressed.
    writer_threads = max(1, thread_count // 2)
    if remapped_read_output == "-":
        remapped_writer = BamWriter(sys.stdout.buffer, header, level=0)
    else:
        remapped_writer = BamWriter(
            remapped_read_output, header, n_threads=writer_threads
        )
    unassembled_writer = BamWriter(
        unassembled_read_output, header, n_threads=writer_threads
    )

    def emit(records: list[BamRecord]) -> None:
        for rec in records:
            remapped_writer.write(rec)

    # Multi-host: this host lifts only reads whose primary alignment is on an
    # owned contig; the unassembled pass-through runs on host 0 only
    # (portello_tpu_torch.parallel.distributed ownership plan).
    emit_unmapped = shard_plan is None or shard_plan.host_id == 0

    # Progress in assembly-contig kb, matching the reference's reporter units
    # (read_alignment_scanner.rs:613-624).
    from portello_tpu_torch.utils.progress import ProgressReporter

    genome_kb = sum(c.length for c in contig_list.data) // 1000
    # exclusive cumulative contig lengths: progress transitions are O(1)
    # (recomputing the prefix sum per transition is O(contigs^2) on a
    # fragmented draft assembly)
    cum_len = np.zeros(len(contig_list.data) + 1, np.int64)
    np.cumsum([c.length for c in contig_list.data], out=cum_len[1:])
    progress = ProgressReporter(
        genome_kb, "Remapped read alignments from", "assembly contig kb"
    )
    last_progress = [0, 0]  # (tid, pos) of last report

    from portello_tpu_torch.io.aln_input import open_alignment_input

    # CRAM decode reference by NAME: the read-to-assembly file's tids are
    # its own header's sequences; positional ref-genome arrays would decode
    # RR=1 slices against the wrong chromosome (CramReader validates
    # name+length and errors when the needed assembly isn't available).
    ref_by_name = {
        c.label: seq for c, seq in zip(ref_chrom_list.data, reference)
    }
    n_primary = 0
    with open_alignment_input(read_to_assembly_bam, reference=ref_by_name) as reader:
        record_source = reader
        if (
            shard_plan is not None
            and hasattr(reader, "fetch_unmapped")
            and not hasattr(reader, "iter_raw")
        ):
            # CRAM + contig-shard runs: this process lifts only reads whose
            # PRIMARY alignment is on an owned contig (the same
            # shard_plan.owns(record.tid) test the loop below applies), so
            # fetching just the owned contigs' containers by .crai seek is
            # sound.  Narrowing by --target-region is deliberately NOT done:
            # a read's primary can sit on a filtered-out contig while an SA
            # split segment maps onto a surviving one — skipping that contig
            # would silently drop the split's lifted records (the reference
            # scans every contig too, read_alignment_scanner.rs:638).
            try:
                reader.load_index()
            except FileNotFoundError:
                pass  # direct API use without an index: full scan
            else:
                def _targeted_records():
                    owned = [
                        (ci, contig_list.data[ci].length)
                        for ci in range(len(all_contig_mapping_info))
                        if shard_plan.owns(ci)
                    ]
                    yield from reader.fetch_many(owned)
                    if emit_unmapped:
                        yield from reader.fetch_unmapped()

                record_source = _targeted_records()
                logger.info(
                    "Serving this shard's CRAM reads by .crai slice seek"
                )
        for record in record_source:
            if record.is_unmapped():
                # Reference semantics: only the UNPLACED unmapped section is
                # copied through (FetchDefinition::Unmapped,
                # read_alignment_scanner.rs:537-559); a placed unmapped record
                # would fail the scan's assert (:396).
                if record.tid >= 0:
                    raise AssertionError(
                        "unexpected placed unmapped record in read: "
                        f"{record.qname.decode()}"
                    )
                if emit_unmapped:
                    if record.raw is not None:
                        unassembled_writer.write_raw(record.raw)
                    else:  # CRAM input: no raw BAM bytes to pass through
                        unassembled_writer.write(record)
                continue
            if record.is_supplementary():
                continue
            if record.tid != last_progress[0]:
                done = int(cum_len[record.tid]) // 1000
                progress.inc(max(done - progress.count, 0))
                last_progress = [record.tid, record.pos]
            if shard_plan is not None and not shard_plan.owns(record.tid):
                continue
            n_primary += 1
            if engine is not None:
                engine.submit(record, emit)
            else:
                emit(
                    process_read(
                        record,
                        reference,
                        ref_chrom_list,
                        contig_list,
                        all_contig_mapping_info,
                        is_target_region,
                    )
                )
        if engine is not None:
            engine.flush(emit)

    progress.clear()
    remapped_writer.close()
    unassembled_writer.close()
    if engine is not None:
        s = engine.stats
        logger.info(
            f"Lifted {n_primary} primary reads: {s['device_items']} device "
            f"work items, {s['host_items']} host items "
            f"({s['fallback_items']} window/bucket fallbacks)"
        )
    else:
        logger.info(f"Lifted {n_primary} primary reads on the host path")
