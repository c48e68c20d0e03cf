"""General utilities: coordinate types, chromosome lists, region partitioning,
progress reporting, and small containers (parity layer for the reference's
rust-vc-utils crate)."""

from portello_tpu_torch.utils.int_range import IntRange
from portello_tpu_torch.utils.chrom_list import ChromInfo, ChromList
from portello_tpu_torch.utils.genome_segment import GenomeSegment, parse_samtools_region_string
from portello_tpu_torch.utils.regions import get_region_segments, get_region_segments_with_offset

__all__ = [
    "IntRange",
    "ChromInfo",
    "ChromList",
    "GenomeSegment",
    "parse_samtools_region_string",
    "get_region_segments",
    "get_region_segments_with_offset",
]
