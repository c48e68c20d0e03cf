"""BAI / CSI index parsing and region queries (htslib index replacement).

Formats per SAM spec sections 5.2 (BAI: binning with min_shift=14, depth=5 plus
a 16 kb linear index) and the CSI spec (generalized min_shift/depth with
per-bin loffset).  Provides the region -> chunk-list query that backs
``BamReader.fetch`` (the reference's ``IndexedReader.fetch``,
reference worker_thread_data.rs:8-30 usage).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field


@dataclass
class RefIndex:
    bins: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    loffsets: dict[int, int] = field(default_factory=dict)  # CSI per-bin loffset
    linear: list[int] = field(default_factory=list)  # BAI 16kb linear index
    n_mapped: int = -1
    n_unmapped: int = -1


def reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    """Bin containing the whole interval (htslib hts_reg2bin; reference
    bam_utils/util.rs:10-35)."""
    end -= 1
    l = depth
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    while l > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        l -= 1
        s += 3
        t -= 1 << (l * 3)
    return 0


def bam_reg2bin(beg: int, end: int) -> int:
    """BAM record bin field (reference bam_utils/util.rs:29-35)."""
    return reg2bin(beg, end, 14, 5)


def reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> list[int]:
    """All bins overlapping the interval (htslib hts_itr_query scheme)."""
    bins = []
    end -= 1
    l = 0
    t = 0
    s = min_shift + depth * 3
    while l <= depth:
        b = t + (beg >> s)
        e = t + (end >> s)
        bins.extend(range(b, e + 1))
        s -= 3
        t += 1 << (l * 3)
        l += 1
    return bins


class BamIndex:
    """Parsed BAI or CSI index."""

    def __init__(self, min_shift: int, depth: int, refs: list[RefIndex], is_csi: bool):
        self.min_shift = min_shift
        self.depth = depth
        self.refs = refs
        self.is_csi = is_csi

    @staticmethod
    def load(bam_path: str) -> "BamIndex":
        for suffix, parser in ((".bai", BamIndex._parse_bai), (".csi", BamIndex._parse_csi)):
            for candidate in (bam_path + suffix, bam_path.rsplit(".", 1)[0] + suffix):
                try:
                    with open(candidate, "rb") as f:
                        raw = f.read()
                except OSError:
                    continue
                if raw[:2] == b"\x1f\x8b":  # CSI files are bgzf/gzip compressed
                    raw = gzip.decompress(raw)
                return parser(raw)
        raise FileNotFoundError(f"No .bai/.csi index found for {bam_path}")

    @staticmethod
    def _parse_bai(raw: bytes) -> "BamIndex":
        if raw[:4] != b"BAI\x01":
            raise ValueError("bad BAI magic")
        off = 4
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            ref = RefIndex()
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = list(
                    struct.unpack_from(f"<{2 * n_chunk}Q", raw, off)
                )
                off += 16 * n_chunk
                pairs = list(zip(chunks[0::2], chunks[1::2]))
                if bin_id == 37450:  # pseudo-bin: file range + mapped counts
                    if len(pairs) == 2:
                        ref.n_mapped, ref.n_unmapped = pairs[1]
                    continue
                ref.bins[bin_id] = pairs
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            ref.linear = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
            off += 8 * n_intv
            refs.append(ref)
        return BamIndex(14, 5, refs, is_csi=False)

    @staticmethod
    def _parse_csi(raw: bytes) -> "BamIndex":
        if raw[:4] != b"CSI\x01":
            raise ValueError("bad CSI magic")
        min_shift, depth, l_aux = struct.unpack_from("<iii", raw, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        refs = []
        pseudo_bin = ((1 << ((depth + 1) * 3)) - 1) // 7 + 1
        for _ in range(n_ref):
            ref = RefIndex()
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            for _ in range(n_bin):
                bin_id, loffset, n_chunk = struct.unpack_from("<IQi", raw, off)
                off += 16
                chunks = list(struct.unpack_from(f"<{2 * n_chunk}Q", raw, off))
                off += 16 * n_chunk
                pairs = list(zip(chunks[0::2], chunks[1::2]))
                if bin_id == pseudo_bin:
                    if len(pairs) == 2:
                        ref.n_mapped, ref.n_unmapped = pairs[1]
                    continue
                ref.bins[bin_id] = pairs
                ref.loffsets[bin_id] = loffset
            refs.append(ref)
        return BamIndex(min_shift, depth, refs, is_csi=True)

    def query(self, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged chunk list (virtual-offset pairs) overlapping the region."""
        if tid < 0 or tid >= len(self.refs):
            return []
        ref = self.refs[tid]
        min_off = 0
        if self.is_csi:
            # loffset of the smallest bin containing beg, walking up levels.
            b = reg2bin(beg, beg + 1, self.min_shift, self.depth)
            while True:
                if b in ref.loffsets:
                    min_off = ref.loffsets[b]
                    break
                if b == 0:
                    break
                b = (b - 1) >> 3
        elif ref.linear:
            i = min(beg >> 14, len(ref.linear) - 1)
            min_off = ref.linear[i]
        chunks = []
        for b in reg2bins(beg, end, self.min_shift, self.depth):
            for cb, ce in ref.bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged: list[list[int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        return [(a, b) for a, b in merged]

    def max_mapped_voffset(self) -> int:
        """Greatest chunk end over all refs: where trailing unmapped records
        begin (htslib's unmapped-fetch heuristic, used for
        FetchDefinition::Unmapped parity, reference read_alignment_scanner.rs:537-559)."""
        vmax = 0
        for ref in self.refs:
            for pairs in ref.bins.values():
                for _, ce in pairs:
                    vmax = max(vmax, ce)
        return vmax
