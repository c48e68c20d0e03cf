"""Phase 1: scan the assembly-to-reference BAM into the contig mapping index.

Behavioral equivalent of the reference contig alignment scanner
(reference src/contig_alignment_scanner/mod.rs:25-459 plus its three post-pass
filters).  The output ``AllContigMappingInfo`` (ordered by contig index) is the
single cross-phase data structure: in the TPU pipeline it is flattened into
dense per-segment block tensors and replicated across hosts.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from portello_tpu_torch.ops import cigar as cg
from portello_tpu_torch.ops.blockmap import BlockMap, build_block_map
from portello_tpu_torch.ops.clip import clip_alignment_read_edges
from portello_tpu_torch.ops.score import get_gap_compressed_identity_no_align_match
from portello_tpu_torch.ops.seq import rev_comp
from portello_tpu_torch.pipeline.split_read import (
    SeqOrderSplitReadSegment,
    get_seq_order_read_split_segments,
)
from portello_tpu_torch.utils.chrom_list import ChromList
from portello_tpu_torch.utils.genome_segment import GenomeSegment
from portello_tpu_torch.utils.int_range import IntRange

logger = logging.getLogger("portello-tpu")


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


def _index_unpickler(f):
    """A pickle reader that loads an index written by either CLI into this
    package's classes: the payload names its classes by module path, and
    ``portello_tpu.*`` paths (an index from ``portello_tpu.main``) map to
    ``portello_tpu_torch.*``, so loading never imports the JAX package."""
    import pickle

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "portello_tpu" or module.startswith("portello_tpu."):
                module = "portello_tpu_torch" + module[len("portello_tpu"):]
            return super().find_class(module, name)

    return _Unpickler(f)


def save_contig_index(
    path: str, all_info, ref_chrom_list, assembly_contig_list, target_region,
    max_join_gap,
) -> None:
    """Serialize the phase-1 result (the one cross-phase artifact,
    SURVEY.md section 5 'checkpoint': the natural broadcast/cache object).
    The scan parameters AND both coordinate systems are stored and validated
    on load — the cached segments' chrom_index values are indices into the
    ref chrom list, so an index built against a different contig-to-ref BAM
    must not be silently reused (it would lift to wrong chromosomes)."""
    import pickle
    import tempfile

    payload = {
        "version": _INDEX_VERSION,
        "ref_chroms": [(c.label, c.length) for c in ref_chrom_list.data],
        "contigs": [(c.label, c.length) for c in assembly_contig_list.data],
        "target_region": (
            None if target_region is None
            else (target_region.chrom_index, target_region.range.start,
                  target_region.range.end)
        ),
        "max_join_gap": max_join_gap,
        "info": all_info,
    }
    import os

    # unique temp in the destination dir: concurrent writers (workers racing
    # on a shared path) each publish atomically via os.replace
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", dir=os.path.dirname(path) or "."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_contig_index(
    path: str, ref_chrom_list, assembly_contig_list, target_region,
    max_join_gap,
):
    """Load and validate a saved phase-1 index; raises ValueError on any
    parameter/coordinate-system mismatch."""
    with open(path, "rb") as f:
        payload = _index_unpickler(f).load()
    if payload.get("version") != _INDEX_VERSION:
        raise ValueError(f"contig index {path}: unsupported version")
    if payload["ref_chroms"] != [
        (c.label, c.length) for c in ref_chrom_list.data
    ]:
        raise ValueError(
            f"contig index {path} was built against a different reference "
            "chromosome list"
        )
    if payload["contigs"] != [
        (c.label, c.length) for c in assembly_contig_list.data
    ]:
        raise ValueError(
            f"contig index {path} was built for a different assembly "
            "(contig list mismatch)"
        )
    want_region = (
        None if target_region is None
        else (target_region.chrom_index, target_region.range.start,
              target_region.range.end)
    )
    if payload["target_region"] != want_region:
        raise ValueError(
            f"contig index {path} was built with a different --target-region"
        )
    if payload["max_join_gap"] != max_join_gap:
        raise ValueError(
            f"contig index {path} was built with a different --max-join-gap"
        )
    return payload["info"]


class _NativeP1:
    """ctypes wrapper for the ptscan.cc phase-1 per-record walk.

    Wraps the flat result arrays back into the Python oracle's dataclasses
    (ints/bools/np arrays with identical dtypes, so the pickled contig index
    is byte-identical to the Python walk's).
    """

    def __init__(self, lib, ref_chrom_list, assembly_contig_list, threads):
        import ctypes

        from portello_tpu_torch.pipeline.native_feed import _P1Out, i64p

        self.lib = lib
        self._P1Out = _P1Out
        self._i64p = i64p
        self._ctypes = ctypes
        ref_names = [c.label for c in ref_chrom_list.data]
        ctg_names = [c.label for c in assembly_contig_list.data]

        def cat_off(names):
            cat = "".join(names).encode()
            off = np.zeros(len(names) + 1, np.int64)
            np.cumsum([len(n.encode()) for n in names], out=off[1:])
            return cat, off

        ref_cat, ref_off = cat_off(ref_names)
        ctg_cat, ctg_off = cat_off(ctg_names)
        self._keep = (ref_cat, ref_off, ctg_cat, ctg_off)
        self.h = ctypes.c_void_p(lib.ptscan_p1_create(
            len(ref_names), ref_cat, i64p(ref_off),
            len(ctg_names), ctg_cat, i64p(ctg_off),
            int(max(threads, 1)),
        ))
        if not self.h:
            raise RuntimeError("ptscan_p1_create failed")

    def close(self):
        if self.h:
            self.lib.ptscan_p1_destroy(self.h)
            self.h = None

    def process(self, chunk):
        """Run one chunk of raw BAM record payloads; yield commit ops."""
        if not chunk:
            return
        import ctypes

        from portello_tpu_torch.ops.blockmap import BlockMap
        from portello_tpu_torch.pipeline.split_read import SeqOrderSplitReadSegment

        offs = np.zeros(len(chunk) + 1, np.int64)
        np.cumsum([len(r) for r in chunk], out=offs[1:])
        cat = b"".join(chunk)
        rc = self.lib.ptscan_p1_process(
            self.h, cat, self._i64p(offs), len(chunk)
        )
        if rc != 0:
            msg = self.lib.ptscan_p1_error(self.h).decode()
            if msg.startswith("KE:"):
                raise KeyError(msg[3:])
            raise ValueError(msg)
        out = self._P1Out()
        self.lib.ptscan_p1_results(self.h, ctypes.byref(out))

        def arr(ptr, n, dtype):
            if n == 0:
                return np.zeros(0, dtype)
            # .view(dtype) swaps the ctypes-derived dtype instance for the
            # canonical numpy singleton: pickle memoizes dtypes by identity,
            # so without this the pickled index would differ from the Python
            # walk's byte-for-byte (same values, fatter pickles)
            return np.ctypeslib.as_array(ptr, shape=(n,)).view(dtype)

        rec = arr(out.rec, out.n_rec * 9, np.int64).reshape(-1, 9)
        seg = arr(out.seg, out.n_seg * 11, np.int64).reshape(-1, 11)
        cig = arr(out.cig, out.n_cig * 2, np.int64).reshape(-1, 2)
        bmk = arr(out.bmk, out.n_bm, np.int64)
        bmv = arr(out.bmv, out.n_bm, np.int64)
        rev = arr(out.rev, out.n_rev, np.uint8)
        qn = arr(out.qname, out.n_qname, np.uint8)
        qn_bytes = qn.tobytes()

        for r in rec:
            kind = int(r[0])
            if kind == 0:
                yield None
                continue
            tid, contig = int(r[1]), int(r[2])
            s0, sn = int(r[3]), int(r[4])
            qname = qn_bytes[int(r[7]) : int(r[7]) + int(r[8])].decode()
            if kind == 2:
                srow = seg[s0]
                key = (tid, int(srow[3]), bool(srow[4]),
                       int(srow[0]), int(srow[1]))
                c0, cn = int(srow[7]), int(srow[8])
                b0, bn = int(srow[9]), int(srow[10])
                cigar = cig[c0 : c0 + cn].copy()
                bm = BlockMap(bmk[b0 : b0 + bn].copy(), bmv[b0 : b0 + bn].copy())
                yield (tid, contig, qname, None, (key, cigar, bm))
                continue
            infos = []
            for srow in seg[s0 : s0 + sn]:
                c0, cn = int(srow[7]), int(srow[8])
                b0, bn = int(srow[9]), int(srow[10])
                infos.append(ContigMappingSegmentInfo(
                    SeqOrderSplitReadSegment(
                        seq_order_read_start=int(srow[0]),
                        seq_order_read_end=int(srow[1]),
                        chrom_index=int(srow[2]),
                        pos=int(srow[3]),
                        is_fwd_strand=bool(srow[4]),
                        cigar=cig[c0 : c0 + cn].copy(),
                        mapq=int(srow[5]),
                        from_primary_bam_record=bool(srow[6]),
                    ),
                    BlockMap(bmk[b0 : b0 + bn].copy(), bmv[b0 : b0 + bn].copy()),
                ))
            rev_seq = None
            if int(r[5]) >= 0:
                rev_seq = rev[int(r[5]) : int(r[5]) + int(r[6])].copy()
            yield (tid, contig, qname, ContigMappingInfo(
                qname=qname,
                ordered_contig_segment_info=infos,
                rev_contig_seq=rev_seq,
            ), None)


def scan_contig_bam(
    bam_path: str,
    ref_chrom_list: ChromList,
    assembly_contig_list: ChromList,
    target_region: GenomeSegment | None,
    max_join_gap: int | None = None,
    reference_seqs=None,
    thread_count: int = 1,
) -> AllContigMappingInfo:
    """(mod.rs:290-459)

    A chunk-parallel full-file scan replaces the reference's rayon fan-out
    over 20 Mb windows (mod.rs:243-283): raw records stream off the native
    BGZF readahead pool, per-record decode + segment/block-map construction
    runs on ``thread_count`` workers (numpy releases the GIL on the hot
    ops), and results commit on the caller thread in input order — so
    same-key overwrite semantics match the sequential scan exactly.

    ``max_join_gap`` overrides the colinear-join gap limit (the reference
    hard-codes 1000, joiner.rs:37; surfaced as config per SURVEY section 5).
    """
    from portello_tpu_torch.utils.progress import ProgressReporter

    logger.info(f"Processing contig-to-ref alignment file '{bam_path}'")
    contig_count = len(assembly_contig_list)
    result: list[ContigMappingInfo] = [ContigMappingInfo() for _ in range(contig_count)]
    supp_cigars: list[dict] = [dict() for _ in range(contig_count)]

    # Progress in ref-genome kb, the reference's reporter units
    # (mod.rs:315-323).
    genome_kb = sum(c.length for c in ref_chrom_list.data) // 1000
    progress = ProgressReporter(
        genome_kb, "Scanned contig alignments from", "ref genome kb"
    )
    last_tid = -1

    from portello_tpu_torch.io.aln_input import open_alignment_input

    # CRAM decode reference by NAME (validated against the file's own @SQ
    # name+length; the contig-to-ref CRAM's tids ARE ref chromosomes, but
    # name-keyed lookup makes wrong-reference decode impossible).
    ref_arg = reference_seqs
    if reference_seqs is not None and not isinstance(reference_seqs, dict):
        ref_arg = {
            c.label: seq for c, seq in zip(ref_chrom_list.data, reference_seqs)
        }
    def process_record(record):
        """Per-record compute (worker-safe: touches only the record and
        read-only lists); returns a commit op or None."""
        if record.is_unmapped() or record.is_secondary():
            return None
        qname = record.qname.decode()
        contig_id = assembly_contig_list.label_to_index[qname]
        if not record.is_supplementary():
            return (record.tid, contig_id, qname,
                    _add_primary_read(ref_chrom_list, record), None)
        key = (
            record.tid,
            record.pos,
            not record.is_reverse(),
            *_clip_pair(record.cigar),
        )
        bm = build_block_map(record.pos, record.cigar, False)
        return (record.tid, contig_id, qname, None, (key, record.cigar, bm))

    def commit(op):
        nonlocal last_tid
        if op is None:
            return
        tid, contig_id, qname, primary, supp = op
        if tid != last_tid:
            done = sum(c.length for c in ref_chrom_list.data[:tid]) // 1000
            progress.inc(max(done - progress.count, 0))
            last_tid = tid
        if primary is not None:
            result[contig_id] = primary
        else:
            key, cigar, bm = supp
            if key in supp_cigars[contig_id]:
                raise ValueError(
                    f"Can't uniquely identify split read alignment info in "
                    f"contig '{qname}'"
                )
            supp_cigars[contig_id][key] = (cigar, bm)

    with open_alignment_input(bam_path, reference=ref_arg) as reader:
        native = getattr(reader, "_native", None)
        is_bam = hasattr(reader, "iter_raw")
        p1lib = None
        if is_bam and os.environ.get("PTPU_P1_NATIVE", "1") != "0":
            try:
                from portello_tpu_torch.pipeline.native_feed import get_lib as _p1_get_lib

                p1lib = _p1_get_lib()
            except Exception:  # pragma: no cover - build-env dependent
                p1lib = None
        if p1lib is not None:
            # Native per-record walk (ptscan.cc phase-1 engine): raw records
            # stream off the BGZF decode pool in chunks; split parse, block
            # maps and rev-comp run on the C++ pool (no GIL); the Python side
            # only wraps the flat results into the oracle's dataclasses and
            # commits in input order — byte-identical to the Python walk
            # (tests/test_contig_scan_parallel.py).
            if native is not None:
                native.set_threads(thread_count)
            reader._bgzf.seek_voffset(reader._data_voffset)
            p1 = _NativeP1(
                p1lib, ref_chrom_list, assembly_contig_list, thread_count
            )
            try:
                chunk: list = []
                nbytes = 0
                max_chunk, max_bytes = 512, 16 << 20
                for raw in reader.iter_raw():
                    chunk.append(raw)
                    nbytes += len(raw)
                    if len(chunk) >= max_chunk or nbytes >= max_bytes:
                        for op in p1.process(chunk):
                            commit(op)
                        chunk, nbytes = [], 0
                for op in p1.process(chunk):
                    commit(op)
            finally:
                p1.close()
        elif thread_count > 1 and native is not None:
            # parallel inflate readahead + worker-parallel record compute,
            # ordered commit (BamReader path; CRAM input stays sequential)
            import collections
            from concurrent.futures import ThreadPoolExecutor

            from portello_tpu_torch.io.bam import BamRecord

            native.set_threads(thread_count)
            reader._bgzf.seek_voffset(reader._data_voffset)

            def work(chunk):
                return [
                    process_record(BamRecord.decode(raw, lazy=True))
                    for raw in chunk
                ]

            # chunked fan-out: amortizes future overhead on many-small-contig
            # inputs; the byte cap bounds in-flight memory on multi-Mb contigs
            max_chunk, max_bytes = 64, 4 << 20
            with ThreadPoolExecutor(max_workers=thread_count) as pool:
                pending: collections.deque = collections.deque()
                chunk: list = []
                nbytes = 0

                def flush():
                    nonlocal chunk, nbytes
                    if chunk:
                        pending.append(pool.submit(work, chunk))
                        chunk, nbytes = [], 0

                for raw in reader.iter_raw():
                    chunk.append(raw)
                    nbytes += len(raw)
                    if len(chunk) >= max_chunk or nbytes >= max_bytes:
                        flush()
                        if len(pending) >= 2 * thread_count:
                            for op in pending.popleft().result():
                                commit(op)
                flush()
                while pending:
                    for op in pending.popleft().result():
                        commit(op)
        elif is_bam:
            from portello_tpu_torch.io.bam import BamRecord

            reader._bgzf.seek_voffset(reader._data_voffset)
            for raw in reader.iter_raw():
                commit(process_record(BamRecord.decode(raw, lazy=True)))
        else:
            for record in reader:
                commit(process_record(record))

    # Patch exact supplementary CIGARs into the non-primary segments
    # (mod.rs:360-439); hard error when missing in WGS mode.
    for contig_index, info in enumerate(result):
        for seg_info in info.ordered_contig_segment_info:
            seg = seg_info.seq_order_segment
            if seg.from_primary_bam_record:
                continue
            key = _split_read_key(seg)
            found = supp_cigars[contig_index].get(key)
            if found is not None:
                seg.cigar = found[0]
                seg_info.contig_to_ref_map = found[1]
            elif target_region is None:
                contig_name = assembly_contig_list.data[contig_index].label
                chrom_name = ref_chrom_list.data[seg.chrom_index].label
                raise ValueError(
                    "Can't find supplementary alignment record corresponding "
                    "to segment reported in SA tag for contig "
                    f"'{contig_name}' (maps to {chrom_name}:{seg.pos} "
                    f"fwd_strand?: {seg.is_fwd_strand})"
                )

    progress.clear()
    filter_non_targeted_segments(target_region, result)
    clip_repeated_contig_matches(result)
    join_colinear_contig_segments(result, max_join_gap)
    return result


def _clip_pair(cigar: np.ndarray) -> tuple[int, int]:
    read_start, read_end, read_size = cg.get_read_clip_positions(cigar, False)
    return read_start, read_size - read_end


# ---------------------------------------------------------------------------
# Target-region filter (non_targeted_segment_filter.rs:7-39)
# ---------------------------------------------------------------------------

def filter_non_targeted_segments(
    target_region: GenomeSegment | None, result: AllContigMappingInfo
) -> None:
    """Keep only split segments whose ref START position is in the target
    region (start-in-region semantics deliberately mirror the reference's scan
    limitation, non_targeted_segment_filter.rs:24-34)."""
    if target_region is None:
        return
    for info in result:
        info.ordered_contig_segment_info = [
            x
            for x in info.ordered_contig_segment_info
            if target_region.intersect(
                GenomeSegment(
                    x.seq_order_segment.chrom_index,
                    IntRange.from_int(x.seq_order_segment.pos),
                )
            )
        ]


# ---------------------------------------------------------------------------
# Repeated-match trimmer (contig_repeated_match_trimmer.rs:18-303)
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
