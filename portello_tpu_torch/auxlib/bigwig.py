"""BigWig (BBI) coverage-track writer + reader.

Parity for the reference's bigwig helper (reference
lib/rust-vc-utils/src/bigwig_utils.rs:7-23, wrapping the C libBigWig): write
per-base/interval value tracks as BigWig.  Implemented from the BBI format
(Kent et al. 2010, supplementary tables): common header, chromosome B+ tree,
zlib-compressed bedGraph-type data sections, R-tree section index, total
summary, and zoom levels (libBigWig — the library the reference wraps —
emits them, and large-track consumers expect them: a reduction ladder of
aggregated 32-byte summary records, each level with its own R-tree).

No external BigWig implementation exists in this image to cross-validate, so
conformance is via structure-level round-trip tests (tests/test_bigwig.py)
plus field-layout assertions against the published format tables.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0
_BEDGRAPH = 1

# one data section per this many intervals (sections compress independently)
ITEMS_PER_SECTION = 1024
# zoom ladder: first reduction ~10x the mean interval span, x4 per level
# (the libBigWig/Kent construction), capped at 10 levels
MAX_ZOOM_LEVELS = 10


def _zoom_reductions(items, chroms) -> list[int]:
    if not items:
        return []
    total_span = sum(e - s for _, s, e, _ in items)
    mean = max(1, total_span // len(items))
    red = max(10 * mean, 16)
    longest = max((length for _, length in chroms), default=0)
    out = []
    while len(out) < MAX_ZOOM_LEVELS and red < longest:
        out.append(int(red))
        red *= 4
    return out


def _zoom_records(items, reduction: int, chrom_lens: list[int]):
    """Aggregate (cid, start, end, value) intervals into fixed bins of
    ``reduction`` bases: (cid, start, end, validCount, min, max, sum,
    sumSq) zoom records, sorted by (cid, bin)."""
    recs: dict[tuple[int, int], list[float]] = {}
    for cid, st, en, v in items:
        b = st // reduction
        while st < en:
            bin_end = (b + 1) * reduction
            seg = min(en, bin_end) - st
            r = recs.get((cid, b))
            if r is None:
                recs[(cid, b)] = [seg, v, v, v * seg, v * v * seg]
            else:
                r[0] += seg
                r[1] = min(r[1], v)
                r[2] = max(r[2], v)
                r[3] += v * seg
                r[4] += v * v * seg
            st = min(en, bin_end)
            b += 1
    out = []
    for cid, b in sorted(recs):
        valid, mn, mx, sm, ssq = recs[(cid, b)]
        end = min((b + 1) * reduction, chrom_lens[cid])
        out.append((cid, b * reduction, end, int(valid), mn, mx, sm, ssq))
    return out


def _zoom_reduce(prev, reduction: int, chrom_lens: list[int]):
    """Build the next ladder level from the previous level's records.

    Levels step by 4x and bins align, so each coarse bin is the exact
    combination of its (up to 4) fine bins — identical records to a fresh
    `_zoom_records` pass at a fraction of the cost (the fine records
    shrink 4x per level; the raw interval list does not)."""
    recs: dict[tuple[int, int], list[float]] = {}
    for cid, st, _en, valid, mn, mx, sm, ssq in prev:
        b = st // reduction
        r = recs.get((cid, b))
        if r is None:
            recs[(cid, b)] = [valid, mn, mx, sm, ssq]
        else:
            r[0] += valid
            r[1] = min(r[1], mn)
            r[2] = max(r[2], mx)
            r[3] += sm
            r[4] += ssq
    out = []
    for cid, b in sorted(recs):
        valid, mn, mx, sm, ssq = recs[(cid, b)]
        end = min((b + 1) * reduction, chrom_lens[cid])
        out.append((cid, b * reduction, end, int(valid), mn, mx, sm, ssq))
    return out


@dataclass
class _Section:
    chrom_id: int
    start: int
    end: int
    offset: int
    size: int


def write_bigwig(path: str, chroms: list[tuple[str, int]], intervals) -> None:
    """Write a BigWig file.

    ``chroms``: ordered (name, length) pairs; ``intervals``: iterable of
    (chrom_name, start, end, value) in file order (sorted by chrom then
    start, the BBI requirement).
    """
    chrom_ids = {name: i for i, (name, _) in enumerate(chroms)}
    by_id = list(chroms)

    items: list[tuple[int, int, int, float]] = []
    last = (-1, -1)
    for name, start, end, val in intervals:
        cid = chrom_ids[name]
        if end <= start:
            raise ValueError(f"empty interval {name}:{start}-{end}")
        if (cid, start) < last:
            raise ValueError("intervals must be sorted by (chrom, start)")
        last = (cid, start)
        items.append((cid, int(start), int(end), float(val)))

    reductions = _zoom_reductions(items, by_id)
    chrom_lens = [length for _, length in by_id]

    with open(path, "wb") as f:
        # placeholder common header + zoom headers + summary; rewritten at
        # the end (zoom headers sit directly after the 64-byte header)
        f.write(b"\x00" * 64)
        zoom_header_offset = f.tell()
        f.write(b"\x00" * (24 * len(reductions)))
        total_summary_offset = f.tell()
        f.write(b"\x00" * 40)

        chrom_tree_offset = f.tell()
        f.write(_encode_chrom_tree(by_id))

        full_data_offset = f.tell()
        f.write(struct.pack("<I", 0))  # dataCount placeholder (section count)

        sections: list[_Section] = []
        max_raw = 0
        valid = 0
        vmin, vmax, vsum, vsumsq = float("inf"), float("-inf"), 0.0, 0.0
        for s0 in range(0, len(items), ITEMS_PER_SECTION):
            chunk = items[s0 : s0 + ITEMS_PER_SECTION]
            # sections may not span chromosomes: split at EVERY chromosome
            # change in the chunk (a chunk can cross several small contigs;
            # cutting only at the first would mix coordinate systems under
            # one chrom_id)
            parts = []
            p0 = 0
            for k in range(1, len(chunk)):
                if chunk[k][0] != chunk[k - 1][0]:
                    parts.append(chunk[p0:k])
                    p0 = k
            parts.append(chunk[p0:])
            for part in parts:
                if not part:
                    continue
                cid = part[0][0]
                sec_start = part[0][1]
                sec_end = max(p[2] for p in part)
                raw = bytearray(
                    struct.pack(
                        "<IIIIIBBH", cid, sec_start, sec_end, 0, 0,
                        _BEDGRAPH, 0, len(part),
                    )
                )
                for _, st, en, v in part:
                    raw += struct.pack("<IIf", st, en, v)
                    span = en - st
                    valid += span
                    vmin = min(vmin, v)
                    vmax = max(vmax, v)
                    vsum += v * span
                    vsumsq += v * v * span
                max_raw = max(max_raw, len(raw))
                comp = zlib.compress(bytes(raw), 6)
                off = f.tell()
                f.write(comp)
                sections.append(
                    _Section(cid, sec_start, sec_end, off, len(comp))
                )

        full_index_offset = f.tell()
        f.write(_encode_rtree(sections, full_index_offset))

        # zoom levels: per reduction, aggregated records in compressed
        # sections (split at chromosome changes, like the data sections)
        # followed by that level's own R-tree
        zoom_offsets: list[tuple[int, int, int]] = []
        zrecs = None
        for red in reductions:
            zrecs = (
                _zoom_records(items, red, chrom_lens)
                if zrecs is None
                else _zoom_reduce(zrecs, red, chrom_lens)
            )
            zdata_offset = f.tell()
            f.write(struct.pack("<I", len(zrecs)))
            zsections: list[_Section] = []
            i0 = 0
            while i0 < len(zrecs):
                part = [zrecs[i0]]
                while (
                    len(part) < ITEMS_PER_SECTION
                    and i0 + len(part) < len(zrecs)
                    and zrecs[i0 + len(part)][0] == part[0][0]
                ):
                    part.append(zrecs[i0 + len(part)])
                i0 += len(part)
                raw = bytearray()
                for zc, zst, zen, zvalid, zmn, zmx, zsm, zssq in part:
                    raw += struct.pack(
                        "<IIIIffff", zc, zst, zen, zvalid, zmn, zmx, zsm, zssq
                    )
                max_raw = max(max_raw, len(raw))
                comp = zlib.compress(bytes(raw), 6)
                off = f.tell()
                f.write(comp)
                zsections.append(
                    _Section(part[0][0], part[0][1], part[-1][2], off,
                             len(comp))
                )
            zindex_offset = f.tell()
            f.write(_encode_rtree(zsections, zindex_offset))
            zoom_offsets.append((red, zdata_offset, zindex_offset))

        end_offset = f.tell()

        # rewrite dataCount
        f.seek(full_data_offset)
        f.write(struct.pack("<I", len(sections)))
        # zoom headers
        f.seek(zoom_header_offset)
        for red, zdo, zio in zoom_offsets:
            f.write(struct.pack("<IIQQ", red, 0, zdo, zio))
        # total summary
        f.seek(total_summary_offset)
        if valid == 0:
            vmin = vmax = 0.0
        f.write(struct.pack("<Qdddd", valid, vmin, vmax, vsum, vsumsq))
        # common header
        f.seek(0)
        f.write(
            struct.pack(
                "<IHHQQQHHQQIQ",
                BIGWIG_MAGIC, 4, len(reductions),
                chrom_tree_offset, full_data_offset, full_index_offset,
                0, 0, 0, total_summary_offset, max_raw + 64, 0,
            )
        )
        f.seek(end_offset)


def _encode_chrom_tree(chroms: list[tuple[str, int]]) -> bytes:
    if len(chroms) > 65535:
        # node item count is u16; a multi-node B+ tree is not implemented
        raise ValueError(
            f"bigwig chrom tree supports at most 65535 sequences "
            f"(got {len(chroms)})"
        )
    key_size = max((len(n) for n, _ in chroms), default=1)
    out = bytearray(
        struct.pack(
            "<IIIIQQ", CHROM_TREE_MAGIC, max(len(chroms), 1), key_size, 8,
            len(chroms), 0,
        )
    )
    # single leaf node holding every chromosome
    out += struct.pack("<BBH", 1, 0, len(chroms))
    for cid, (name, length) in enumerate(chroms):
        out += name.encode().ljust(key_size, b"\x00")
        out += struct.pack("<II", cid, length)
    return bytes(out)


def _encode_rtree(sections: list[_Section], index_offset: int) -> bytes:
    n = len(sections)
    if n:
        s_cid = min(s.chrom_id for s in sections)
        s_base = min(s.start for s in sections if s.chrom_id == s_cid)
        e_cid = max(s.chrom_id for s in sections)
        e_base = max(s.end for s in sections if s.chrom_id == e_cid)
        end_file = max(s.offset + s.size for s in sections)
    else:
        s_cid = s_base = e_cid = e_base = 0
        end_file = index_offset
    out = bytearray(
        struct.pack(
            "<IIQIIIIQII",
            RTREE_MAGIC, max(n, 1), n, s_cid, s_base, e_cid, e_base,
            end_file, 1, 0,
        )
    )

    def leaf_bytes(part):
        b = bytearray(struct.pack("<BBH", 1, 0, len(part)))
        for s in part:
            b += struct.pack(
                "<IIIIQQ", s.chrom_id, s.start, s.chrom_id, s.end, s.offset,
                s.size,
            )
        return b

    LEAF_CAP = 32768  # node item count is u16; cap well below 65535
    if n <= LEAF_CAP:
        out += leaf_bytes(sections)
        return bytes(out)

    # two-level tree: a non-leaf root pointing at <=LEAF_CAP-item leaves
    # (the section count of a WGS coverage track exceeds one node's u16)
    parts = [sections[i : i + LEAF_CAP] for i in range(0, n, LEAF_CAP)]
    if len(parts) > 65535:
        raise ValueError("bigwig R-tree exceeds two-level capacity")
    root = bytearray(struct.pack("<BBH", 0, 0, len(parts)))
    root_size = 4 + 24 * len(parts)
    child_off = index_offset + 48 + root_size
    leaves = []
    for part in parts:
        lb = leaf_bytes(part)
        root += struct.pack(
            "<IIIIQ", part[0].chrom_id, min(s.start for s in part),
            part[-1].chrom_id, max(s.end for s in part), child_off,
        )
        leaves.append(lb)
        child_off += len(lb)
    out += root
    for lb in leaves:
        out += lb
    return bytes(out)


class BigWigReader:
    """Minimal BBI reader: header, chrom tree, R-tree walk, section decode."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        hdr = self.f.read(64)
        (magic, self.version, self.zoom_levels, self.chrom_tree_offset,
         self.full_data_offset, self.full_index_offset, _fc, _dfc, _asql,
         self.total_summary_offset, self.uncompress_buf, _res) = struct.unpack(
            "<IHHQQQHHQQIQ", hdr
        )
        if magic != BIGWIG_MAGIC:
            raise ValueError(f"{path}: not a BigWig file")
        # zoom headers follow the 64-byte common header
        self.zooms: list[dict] = []
        for _ in range(self.zoom_levels):
            red, _res, zdo, zio = struct.unpack("<IIQQ", self.f.read(24))
            self.zooms.append(
                {"reduction": red, "data_offset": zdo, "index_offset": zio}
            )
        self.chroms = self._read_chrom_tree()

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_chrom_tree(self):
        self.f.seek(self.chrom_tree_offset)
        magic, _bs, key_size, _vs, item_count, _ = struct.unpack(
            "<IIIIQQ", self.f.read(32)
        )
        if magic != CHROM_TREE_MAGIC:
            raise ValueError("bad chromosome B+ tree magic")
        chroms: dict[int, tuple[str, int]] = {}

        def walk():
            is_leaf, _, count = struct.unpack("<BBH", self.f.read(4))
            if is_leaf:
                for _ in range(count):
                    key = self.f.read(key_size).rstrip(b"\x00").decode()
                    cid, length = struct.unpack("<II", self.f.read(8))
                    chroms[cid] = (key, length)
            else:
                offs = []
                for _ in range(count):
                    self.f.read(key_size)
                    offs.append(struct.unpack("<Q", self.f.read(8))[0])
                for off in offs:
                    self.f.seek(off)
                    walk()

        walk()
        return [chroms[i] for i in sorted(chroms)]

    def summary(self):
        self.f.seek(self.total_summary_offset)
        valid, vmin, vmax, vsum, vsumsq = struct.unpack(
            "<Qdddd", self.f.read(40)
        )
        return {
            "valid_count": valid, "min": vmin, "max": vmax,
            "sum": vsum, "sum_squares": vsumsq,
        }

    def _leaf_items(self, index_offset: int | None = None):
        self.f.seek(
            self.full_index_offset if index_offset is None else index_offset
        )
        (magic, _bs, _n, _sc, _sb, _ec, _eb, _ef, _ips, _r) = struct.unpack(
            "<IIQIIIIQII", self.f.read(48)
        )
        if magic != RTREE_MAGIC:
            raise ValueError("bad R-tree magic")

        items = []

        def walk():
            is_leaf, _, count = struct.unpack("<BBH", self.f.read(4))
            if is_leaf:
                for _ in range(count):
                    vals = struct.unpack("<IIIIQQ", self.f.read(32))
                    items.append(vals)
            else:
                kids = []
                for _ in range(count):
                    vals = struct.unpack("<IIIIQ", self.f.read(24))
                    kids.append(vals[4])
                for off in kids:
                    self.f.seek(off)
                    walk()

        walk()
        return items

    def zoom_records(self, level: int):
        """Yield (chrom, start, end, valid_count, min, max, sum, sum_sq)
        aggregated records from one zoom level."""
        z = self.zooms[level]
        name_by_id = {i: n for i, (n, _) in enumerate(self.chroms)}
        for _scid, _sb, _ecid, _eb, off, size in self._leaf_items(
            z["index_offset"]
        ):
            self.f.seek(off)
            raw = self.f.read(size)
            if self.uncompress_buf:
                raw = zlib.decompress(raw)
            for p in range(0, len(raw), 32):
                cid, st, en, valid, mn, mx, sm, ssq = struct.unpack_from(
                    "<IIIIffff", raw, p
                )
                yield (name_by_id[cid], st, en, valid, mn, mx, sm, ssq)

    def intervals(self, chrom: str | None = None):
        """Yield (chrom, start, end, value) from every data section."""
        name_by_id = {i: n for i, (n, _) in enumerate(self.chroms)}
        want = None
        if chrom is not None:
            want = next(
                (i for i, (n, _) in enumerate(self.chroms) if n == chrom),
                None,
            )
            if want is None:
                raise ValueError(f"chromosome '{chrom}' not in bigwig")
        for scid, _sb, ecid, _eb, off, size in self._leaf_items():
            if want is not None and not (scid <= want <= ecid):
                continue
            self.f.seek(off)
            raw = self.f.read(size)
            if self.uncompress_buf:
                raw = zlib.decompress(raw)
            cid, _st, _en, step, span, ty, _r, count = struct.unpack_from(
                "<IIIIIBBH", raw, 0
            )
            if want is not None and cid != want:
                continue
            p = 24
            name = name_by_id[cid]
            if ty == _BEDGRAPH:
                for _ in range(count):
                    st, en, v = struct.unpack_from("<IIf", raw, p)
                    p += 12
                    yield (name, st, en, v)
            elif ty == 2:  # varStep
                for _ in range(count):
                    st, v = struct.unpack_from("<If", raw, p)
                    p += 8
                    yield (name, st, st + span, v)
            elif ty == 3:  # fixedStep
                st = _st
                for _ in range(count):
                    (v,) = struct.unpack_from("<f", raw, p)
                    p += 4
                    yield (name, st, st + span, v)
                    st += step
            else:
                raise ValueError(f"unknown section type {ty}")


def write_coverage_bigwig(path: str, chroms, depth_by_chrom) -> None:
    """Write per-base depth arrays as a run-length bedGraph BigWig (the
    reference helper's coverage-track use case, bigwig_utils.rs:7-23)."""
    def gen():
        for name, _ in chroms:
            depth = np.asarray(depth_by_chrom[name])
            if len(depth) == 0:
                continue
            change = np.flatnonzero(np.diff(depth)) + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [len(depth)]])
            for s, e in zip(starts, ends):
                if depth[s] != 0:
                    yield (name, int(s), int(e), float(depth[s]))

    write_bigwig(path, list(chroms), gen())
