"""Region partitioning: the work-decomposition scheme shared by both pipeline
phases.

Behavioral equivalent of get_region_segments
(reference lib/rust-vc-utils/src/util.rs:50-80): divide a region into balanced
segments none larger than ``segment_size``.
"""

from __future__ import annotations


def get_region_segments(size: int, segment_size: int) -> list[tuple[int, int]]:
    """(util.rs:50-67)"""
    segment_count = 1 + (size - 1) // segment_size
    segment_base = size // segment_count
    n_plus_one = size % segment_count
    intervals = []
    start = 0
    for i in range(segment_count):
        seg = segment_base + (1 if i < n_plus_one else 0)
        end = min(start + seg, size)
        intervals.append((start, end))
        start = end
    return intervals


def get_region_segments_with_offset(
    offset: int, size: int, segment_size: int
) -> list[tuple[int, int]]:
    """(util.rs:71-80)"""
    return [(s + offset, e + offset) for s, e in get_region_segments(size, segment_size)]
