"""Ordered chromosome name/length list: the universal coordinate-system handle.

Behavioral equivalent of the reference ChromList
(reference lib/rust-vc-utils/src/chrom_list.rs:20-55).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ChromInfo:
    label: str
    length: int


@dataclass
class ChromList:
    data: list[ChromInfo] = field(default_factory=list)
    label_to_index: dict[str, int] = field(default_factory=dict)

    def add_chrom(self, label: str, length: int) -> None:
        if label in self.label_to_index:
            raise ValueError(f"Duplicate chromosome label: {label}")
        self.label_to_index[label] = len(self.data)
        self.data.append(ChromInfo(label, int(length)))

    def __len__(self) -> int:
        return len(self.data)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ChromList):
            return NotImplemented
        return [(c.label, c.length) for c in self.data] == [
            (c.label, c.length) for c in other.data
        ]

    @staticmethod
    def from_pairs(pairs) -> "ChromList":
        cl = ChromList()
        for label, length in pairs:
            cl.add_chrom(label, length)
        return cl

    @staticmethod
    def from_bam_header(header) -> "ChromList":
        """Build from a ``bam.BamReader`` header (chrom_list.rs:26-36)."""
        return ChromList.from_pairs(header.reference_sequences())

    @staticmethod
    def from_bam_filename(filename: str) -> "ChromList":
        """(chrom_list.rs:38-43), BAM only."""
        from benchmark.reference.bam import BamReader

        with BamReader(filename) as reader:
            return ChromList.from_bam_header(reader.header)
