"""Integer interval type (bed convention: 0-indexed, half-open).

Behavioral equivalent of the reference IntRange
(reference lib/rust-vc-utils/src/int_range.rs:11-161).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(order=True)
class IntRange:
    start: int = -1
    end: int = 0

    @staticmethod
    def from_int(start: int) -> "IntRange":
        return IntRange(start, start + 1)

    @staticmethod
    def from_pair(start: int, end: int) -> "IntRange":
        return IntRange(start, end)

    def size(self) -> int:
        return self.end - self.start

    def center(self) -> int:
        # Rust i64 division truncates toward zero; Python // floors —
        # they diverge for negative odd sums (e.g. the reference's own
        # IntRange(-1, 0) default: Rust 0, floor -1)
        s = self.start + self.end
        q = abs(s) // 2
        return q if s >= 0 else -q

    def intersect_pos(self, pos: int) -> bool:
        """Position intersects range; adjacency does not count (int_range.rs:49-51)."""
        return self.start <= pos < self.end

    def intersect_range(self, other: "IntRange") -> bool:
        """Ranges intersect (int_range.rs:56-58).

        Note the reference uses ``other.end >= self.start`` (closed on one side);
        preserved verbatim for behavioral parity.
        """
        return other.end >= self.start and other.start < self.end

    def merge(self, other: "IntRange") -> None:
        self.start = min(self.start, other.start)
        self.end = max(self.end, other.end)

    def reverse(self, size: int) -> None:
        """Flip to the reversed coordinate system (int_range.rs:83-87)."""
        self.start, self.end = size - self.end, size - self.start

    def get_reverse_range(self, size: int) -> "IntRange":
        return IntRange(size - self.end, size - self.start)

    def __repr__(self) -> str:  # matches reference Debug format
        return f"[{self.start}-{self.end})"


def get_int_range_distance(r1: IntRange, r2: IntRange) -> int:
    """Gap between two non-intersecting ranges; 0 when they touch
    (int_range.rs:113-116)."""
    return max(r2.start - r1.end, r1.start - r2.end, 0)


def get_int_range_dir_distance(r1: IntRange, r2: IntRange) -> tuple[bool, int]:
    """(direction, distance): direction True when r2 is ahead of r1
    (int_range.rs:123-133)."""
    d21 = r2.start - r1.end
    d12 = r1.start - r2.end
    if d12 > d21:
        dir_, dist = d12 <= 0, d12
    else:
        dir_, dist = True, d21
    return dir_, max(dist, 0)


def get_recip_overlap(r1: IntRange, r2: IntRange) -> float:
    """Reciprocal overlap with a 100 bp minimum span (int_range.rs:135-150)."""
    min_span = 100
    r1_end = max(r1.end, r1.start + min_span)
    r2_end = max(r2.end, r2.start + min_span)
    olap = max(min(r1_end, r2_end) - max(r1.start, r2.start), 0)
    span = max(r1_end - r1.start, r2_end - r2.start)
    return olap / span


def get_overlap_range(r1: IntRange, r2: IntRange) -> IntRange | None:
    """(int_range.rs:153-161)"""
    if not r1.intersect_range(r2):
        return None
    return IntRange(max(r1.start, r2.start), min(r1.end, r2.end))
