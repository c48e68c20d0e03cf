"""Genome segment: (chrom index, interval) + samtools-style region parsing.

Behavioral equivalent of the reference GenomeSegment
(reference lib/rust-vc-utils/src/genome_segment.rs:9-171), including the
best-effort handling of contig names containing colons (HLA alleles) and
comma-stripping in coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from portello_tpu_torch.utils.chrom_list import ChromList
from portello_tpu_torch.utils.int_range import IntRange


@dataclass(order=True)
class GenomeSegment:
    chrom_index: int = 0
    range: IntRange = field(default_factory=IntRange)

    @staticmethod
    def from_region_str(chrom_list: ChromList, region: str) -> "GenomeSegment":
        chrom_index, start, end = parse_samtools_region_string(chrom_list, region)
        return GenomeSegment(chrom_index, IntRange(start, end))

    def to_region_str(self, chrom_list: ChromList) -> str:
        chrom = chrom_list.data[self.chrom_index].label
        return f"{chrom}:{self.range.start + 1}-{self.range.end}"

    def intersect(self, other: "GenomeSegment") -> bool:
        return self.chrom_index == other.chrom_index and self.range.intersect_range(
            other.range
        )

    def expand_by(self, chrom_list: ChromList, size: int) -> tuple[int, int]:
        return self.asymmetric_expand_by(chrom_list, size, size)

    def asymmetric_expand_by(
        self, chrom_list: ChromList, left_size: int, right_size: int
    ) -> tuple[int, int]:
        """(genome_segment.rs:55-69)"""
        chrom_size = chrom_list.data[self.chrom_index].length
        new_start = max(self.range.start - left_size, 0)
        new_end = min(self.range.end + right_size, chrom_size)
        left_shift = self.range.start - new_start
        right_shift = new_end - self.range.end
        self.range.start = new_start
        self.range.end = new_end
        return left_shift, right_shift

    def __repr__(self) -> str:
        return f"Segment: {self.chrom_index}:{self.range!r}"


def _parse_chrom_index(chrom_list: ChromList, region: str) -> tuple[int, str | None]:
    """(genome_segment.rs:83-112)"""
    head, sep, tail = region.rpartition(":")
    chrom = head if sep else region
    if chrom in chrom_list.label_to_index:
        return chrom_list.label_to_index[chrom], (tail if sep else None)
    if region in chrom_list.label_to_index:
        return chrom_list.label_to_index[region], None
    if region != chrom:
        raise ValueError(
            f"Unexpected format in genome region string '{region}': can't find "
            f"chromosome name '{chrom}' or '{region}' in bam file header"
        )
    raise ValueError(
        f"Unexpected format in genome region string '{region}': can't find "
        f"chromosome '{chrom}' in bam file header"
    )


def _parse_pos_range(
    region: str, pos_range: str | None, chrom_size: int
) -> tuple[int, int]:
    """(genome_segment.rs:122-154)"""
    if pos_range is None:
        return 0, chrom_size
    parts = pos_range.split("-")
    if len(parts) > 2:
        raise ValueError(
            f"Unexpected format in position range '{pos_range}' from genome "
            f"region string {region}"
        )
    parts = [p.replace(",", "") for p in parts]
    start = int(parts[0]) - 1
    end = chrom_size if len(parts) == 1 else int(parts[1])
    return start, end


def parse_samtools_region_string(
    chrom_list: ChromList, region: str
) -> tuple[int, int, int]:
    """Parse 'chr20:100-200'-style region into (chrom_index, start, end) in bed
    zero-indexed half-open convention (genome_segment.rs:165-171)."""
    chrom_index, pos_str = _parse_chrom_index(chrom_list, region)
    chrom_size = chrom_list.data[chrom_index].length
    start, end = _parse_pos_range(region, pos_str, chrom_size)
    return chrom_index, start, end
