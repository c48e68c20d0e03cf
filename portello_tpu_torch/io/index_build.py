"""BAI/CSI index construction for coordinate-sorted BAMs.

The reference assumes externally indexed inputs (cli.rs:143-163); this framework
additionally ships indexers so fixtures and downstream pipelines don't need
samtools.  Formats per SAM spec section 5.2 (BAI) and the CSIv1 spec (htslib
hts_idx equivalent; CSI covers contigs past the BAI 2^29 limit).
"""

from __future__ import annotations

import gzip
import struct

from portello_tpu_torch.io.bai import bam_reg2bin, reg2bin
from portello_tpu_torch.io.bam import BamReader


def _scan_records(bam_path: str):
    """Yield (tid, pos, end, flag, v_start, v_end) for every record, plus a
    final ('EOF', n_ref, n_no_coor) sentinel; validates coordinate order."""
    reader = BamReader(bam_path)
    n_ref = len(reader.header.refs)
    n_no_coor = 0
    bgzf = reader._bgzf
    bgzf.seek_voffset(reader._data_voffset)
    last_key = (-1, -1)
    try:
        while True:
            v_start = bgzf.tell_voffset()
            raw = reader._read_record_raw()
            if raw is None:
                break
            v_end = bgzf.tell_voffset()
            tid, pos = struct.unpack_from("<ii", raw, 0)
            flag = struct.unpack_from("<H", raw, 14)[0]
            if tid < 0 or pos < 0:
                n_no_coor += 1
                continue
            if (tid, pos) < last_key:
                raise ValueError(
                    f"Cannot index '{bam_path}': records are not "
                    "coordinate-sorted"
                )
            last_key = (tid, pos)
            # end position from the cigar ops
            n_cigar = struct.unpack_from("<H", raw, 12)[0]
            l_read_name = raw[8]
            ref_len = 0
            off = 32 + l_read_name
            for k in range(n_cigar):
                (u,) = struct.unpack_from("<I", raw, off + 4 * k)
                op = u & 0xF
                if op in (0, 2, 3, 7, 8):  # M D N = X
                    ref_len += u >> 4
            end = pos + max(ref_len, 1)
            yield (tid, pos, end, flag, v_start, v_end)
        yield ("EOF", n_ref, n_no_coor)
    finally:
        reader.close()


class _RefAccum:
    __slots__ = ("bins", "linear", "counts", "vrange")

    def __init__(self):
        self.bins: dict[int, list[list[int]]] = {}
        self.linear: dict[int, int] = {}
        self.counts = [0, 0]
        self.vrange = [None, None]

    def add(self, b, pos, end, flag, v_start, v_end, lin_shift):
        chunks = self.bins.setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1][1] = v_end
        else:
            chunks.append([v_start, v_end])
        for w in range(pos >> lin_shift, ((end - 1) >> lin_shift) + 1):
            if w not in self.linear or self.linear[w] > v_start:
                self.linear[w] = v_start
        self.counts[1 if flag & 0x4 else 0] += 1
        rr = self.vrange
        rr[0] = v_start if rr[0] is None else min(rr[0], v_start)
        rr[1] = v_end if rr[1] is None else max(rr[1], v_end)

    def filled_linear(self):
        if not self.linear:
            return []
        n_intv = max(self.linear) + 1
        out, prev = [], 0
        for w in range(n_intv):
            if w in self.linear:
                prev = self.linear[w]
            out.append(prev)
        return out


def build_bai(bam_path: str, out_path: str | None = None) -> str:
    out_path = out_path or bam_path + ".bai"
    refs: list[_RefAccum] = []
    n_no_coor = 0
    for item in _scan_records(bam_path):
        if item[0] == "EOF":
            _, n_ref, n_no_coor = item
            while len(refs) < n_ref:
                refs.append(_RefAccum())
            break
        tid, pos, end, flag, v_start, v_end = item
        while len(refs) <= tid:
            refs.append(_RefAccum())
        if end > (1 << 29):
            # BAI's 5-level binning tops out at 2^29-1; beyond it reg2bin
            # emits ids that collide with the 37450 pseudo-bin (whose chunks
            # readers silently drop) or fall outside the scheme entirely.
            # htslib refuses and requires CSI here; so do we.
            raise ValueError(
                f"Cannot BAI-index '{bam_path}': alignment end {end} on tid "
                f"{tid} exceeds the BAI limit of 2^29 (build a CSI index: "
                "python -m portello_tpu_torch.tools.index --csi)"
            )
        refs[tid].add(
            bam_reg2bin(pos, end), pos, end, flag, v_start, v_end, 14
        )

    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", len(refs))
    for ref in refs:
        has_meta = ref.vrange[0] is not None
        out += struct.pack("<i", len(ref.bins) + (1 if has_meta else 0))
        for b in sorted(ref.bins):
            chunks = ref.bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if has_meta:  # pseudo-bin 37450
            out += struct.pack("<Ii", 37450, 2)
            out += struct.pack("<QQ", ref.vrange[0], ref.vrange[1])
            out += struct.pack("<QQ", ref.counts[0], ref.counts[1])
        lin = ref.filled_linear()
        out += struct.pack("<i", len(lin))
        if lin:
            out += struct.pack(f"<{len(lin)}Q", *lin)
    out += struct.pack("<Q", n_no_coor)
    with open(out_path, "wb") as f:
        f.write(bytes(out))
    return out_path


def _bin_start(b: int, min_shift: int, depth: int) -> int:
    """Interval start position of bin ``b`` in the (min_shift, depth) scheme."""
    lvl = 0
    t = 0
    while lvl <= depth:
        n_at = 1 << (3 * lvl)
        if b < t + n_at:
            return (b - t) << (min_shift + 3 * (depth - lvl))
        t += n_at
        lvl += 1
    raise ValueError(f"bin {b} outside depth-{depth} scheme")


def build_csi(
    bam_path: str, out_path: str | None = None, min_shift: int = 14,
    depth: int | None = None,
) -> str:
    """Build a CSI index (CSIv1; htslib hts_idx layout).

    ``depth`` defaults to the smallest level count covering the longest
    reference sequence (htslib's rule: grow from 5 until
    ``1 << (min_shift + 3*depth)`` fits), so contigs past the BAI 2^29
    limit index correctly.  Per-bin ``loffset`` comes from a min_shift-
    granularity linear fill, so spanning records in parent bins are never
    excluded by the query's lower-bound filter.
    """
    out_path = out_path or bam_path + ".csi"
    with BamReader(bam_path) as r:
        max_len = max((ln for _, ln in r.header.refs), default=0)
    if depth is None:
        depth = 5
        while max_len > (1 << (min_shift + 3 * depth)):
            depth += 1

    refs: list[_RefAccum] = []
    n_no_coor = 0
    for item in _scan_records(bam_path):
        if item[0] == "EOF":
            _, n_ref, n_no_coor = item
            while len(refs) < n_ref:
                refs.append(_RefAccum())
            break
        tid, pos, end, flag, v_start, v_end = item
        while len(refs) <= tid:
            refs.append(_RefAccum())
        refs[tid].add(
            reg2bin(pos, end, min_shift, depth), pos, end, flag,
            v_start, v_end, min_shift,
        )

    pseudo_bin = ((1 << ((depth + 1) * 3)) - 1) // 7 + 1
    out = bytearray(b"CSI\x01")
    out += struct.pack("<iii", min_shift, depth, 0)  # l_aux = 0
    out += struct.pack("<i", len(refs))
    for ref in refs:
        lin = ref.filled_linear()

        def loffset(b):
            if not lin:
                return 0
            w = min(_bin_start(b, min_shift, depth) >> min_shift, len(lin) - 1)
            return lin[w]

        has_meta = ref.vrange[0] is not None
        out += struct.pack("<i", len(ref.bins) + (1 if has_meta else 0))
        for b in sorted(ref.bins):
            chunks = ref.bins[b]
            out += struct.pack("<IQi", b, loffset(b), len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if has_meta:
            out += struct.pack("<IQi", pseudo_bin, 0, 2)
            out += struct.pack("<QQ", ref.vrange[0], ref.vrange[1])
            out += struct.pack("<QQ", ref.counts[0], ref.counts[1])
    out += struct.pack("<Q", n_no_coor)
    with open(out_path, "wb") as f:
        f.write(gzip.compress(bytes(out)))
    return out_path


def build_crai(cram_path: str, out_path: str | None = None,
               reference=None) -> str:
    """Build a .crai index for an existing CRAM file.

    Walks container headers (skipping bodies wholesale), parses each slice
    header block at its landmark for ref/start/span, and decodes record
    content only for multi-reference (seq_id -2) slices, whose per-reference
    start/span lines require record positions (htslib cram_index_build does
    the same).  The reference requires this index on CRAM inputs
    (cli.rs:147-163 via bam::IndexedReader).

    ``reference``: name-keyed chrom dict, needed only when the CRAM holds
    reference-based (RR=1) multi-reference slices without embedded refs —
    single-ref slices never decode records here.
    """
    from portello_tpu_torch.io import cram as cr
    from portello_tpu_torch.io.crai import CraiEntry, CraiIndex
    from portello_tpu_torch.ops import cigar as cg

    entries: list[CraiEntry] = []
    with cr.CramReader(cram_path, reference=reference) as r:
        f = r.f
        while True:
            c_off = f.tell()
            h = cr.read_container_header(f, r.version)
            if h is None:
                break
            body = f.read(h.length)
            if h.ref_id == -1 and h.n_records == 0 and h.bases == 0:
                break  # EOF container
            landmarks = list(h.landmarks) + [h.length]
            multi_recs = None  # decoded lazily, once per container
            for si in range(len(h.landmarks)):
                s_off = landmarks[si]
                s_size = landmarks[si + 1] - s_off
                blk, _ = cr.read_block(body, s_off, r.version)
                if blk.content_type != cr.SLICE_HEADER:
                    raise cr.CramFormatError(
                        f"{cram_path}: landmark {si} does not point at a "
                        "slice header block"
                    )
                d = blk.data
                s_ref, p = cr.read_itf8(d, 0)
                s_start, p = cr.read_itf8(d, p)
                s_span, p = cr.read_itf8(d, p)
                s_nrec, p = cr.read_itf8(d, p)
                if s_ref == -2:
                    if multi_recs is None:
                        multi_recs = list(r._decode_container(h, body))
                    # records split across slices in order by each slice's
                    # record count; this container writer emits one slice
                    # per container, but external files may not
                    done = 0
                    for sj in range(si):
                        sb, _ = cr.read_block(body, landmarks[sj], r.version)
                        _, q = cr.read_itf8(sb.data, 0)
                        _, q = cr.read_itf8(sb.data, q)
                        _, q = cr.read_itf8(sb.data, q)
                        nr, q = cr.read_itf8(sb.data, q)
                        done += nr
                    per: dict[int, list[int]] = {}
                    for rec in multi_recs[done : done + s_nrec]:
                        if rec.tid < 0:
                            per.setdefault(-1, [0, 0])
                            continue
                        end0 = rec.pos + max(
                            int(cg.get_cigar_ref_offset(rec.cigar)), 1
                        )
                        lohi = per.setdefault(rec.tid, [rec.pos, end0])
                        lohi[0] = min(lohi[0], rec.pos)
                        lohi[1] = max(lohi[1], end0)
                    for tid in sorted(per):
                        lo, hi = per[tid]
                        if tid < 0:
                            entries.append(
                                CraiEntry(-1, 0, 0, c_off, s_off, s_size)
                            )
                        else:
                            entries.append(CraiEntry(
                                tid, lo + 1, hi - lo, c_off, s_off, s_size
                            ))
                else:
                    entries.append(CraiEntry(
                        s_ref, s_start, s_span, c_off, s_off, s_size
                    ))
    out = out_path or (cram_path + ".crai")
    return CraiIndex(entries).save(out)
