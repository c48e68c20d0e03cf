"""CRAM index (.crai) read/write and region queries.

Format per the CRAM spec section 12 / htslib cram_index: a gzip-compressed
text file with one line per (slice, reference) of six tab-separated ints::

    seq_id  alignment_start  alignment_span  container_offset  slice_offset  slice_size

``container_offset`` is the absolute byte offset of the container header;
``slice_offset`` is the slice header block's offset from the end of the
container header (the container "landmark"); multi-reference slices emit one
line per contained reference (htslib convention), and unmapped slices use
``seq_id == -1`` with start/span 0.

The reference requires an index for every alignment input
(``bam::IndexedReader::from_path``, reference cli.rs:147-163) and serves
region fetches from it (read_alignment_scanner.rs:383); for CRAM inputs the
index htslib opens is exactly this file.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass(frozen=True)
class CraiEntry:
    seq_id: int
    start: int  # 1-based alignment start (0 for unmapped)
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int


def _index_candidates(cram_path: str):
    yield cram_path + ".crai"
    # splitext only strips the basename's extension — a plain rsplit(".")
    # would let a dotted DIRECTORY name produce a candidate outside the
    # file's directory (and silently load an unrelated index)
    import os

    stem, ext = os.path.splitext(cram_path)
    if ext:
        yield stem + ".crai"


class CraiIndex:
    """Parsed .crai index with the BamIndex-style query surface."""

    def __init__(self, entries: list[CraiEntry]):
        self.entries = entries
        # per-seq_id entry lists: fetch plans query one contig at a time, so
        # a flat scan would be O(contigs x slices) on fragmented assemblies
        self._by_seq: dict[int, list[CraiEntry]] = {}
        for e in entries:
            self._by_seq.setdefault(e.seq_id, []).append(e)

    @staticmethod
    def load(cram_path: str) -> "CraiIndex":
        for candidate in _index_candidates(cram_path):
            try:
                with open(candidate, "rb") as f:
                    raw = f.read()
            except OSError:
                continue
            if raw[:2] == b"\x1f\x8b":
                raw = gzip.decompress(raw)
            return CraiIndex.parse(raw)
        raise FileNotFoundError(f"No .crai index found for {cram_path}")

    @staticmethod
    def parse(raw: bytes) -> "CraiIndex":
        entries = []
        for line in raw.decode().splitlines():
            line = line.strip()
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) != 6:
                raise ValueError(f"bad .crai line (expected 6 columns): {line!r}")
            entries.append(CraiEntry(*(int(c) for c in cols)))
        return CraiIndex(entries)

    def encode(self) -> bytes:
        text = "".join(
            f"{e.seq_id}\t{e.start}\t{e.span}\t{e.container_offset}\t"
            f"{e.slice_offset}\t{e.slice_size}\n"
            for e in self.entries
        )
        return gzip.compress(text.encode())

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.encode())
        return path

    def query_containers(self, tid: int, beg: int, end: int) -> list[int]:
        """Sorted unique container offsets whose slices overlap
        zero-based [beg, end) on ``tid`` (htslib overlap convention:
        entry covers 1-based [start, start+span))."""
        offs = set()
        for e in self._by_seq.get(tid, ()):
            if e.span <= 0:
                continue
            e_beg0 = e.start - 1
            if e_beg0 < end and e_beg0 + e.span > beg:
                offs.add(e.container_offset)
        return sorted(offs)

    def unmapped_containers(self) -> list[int]:
        """Sorted unique container offsets holding unmapped (seq_id -1)
        slices (FetchDefinition::Unmapped parity,
        reference read_alignment_scanner.rs:537-559)."""
        return sorted({e.container_offset for e in self._by_seq.get(-1, ())})
