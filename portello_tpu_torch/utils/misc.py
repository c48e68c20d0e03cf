"""Miscellaneous utilities (parity with reference lib/rust-vc-utils/src/util.rs)."""

from __future__ import annotations

from typing import Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")


class MeanTracker:
    """Updatable/mergeable mean value tracker (util.rs:4-27)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0.0

    def mean(self) -> float:
        return self.total / self.count if self.count > 0 else 0.0

    def insert(self, x: float) -> None:
        self.total += x
        self.count += 1.0

    def merge(self, other: "MeanTracker") -> None:
        self.total += other.total
        self.count += other.count


def downsample_vector(vec: list[T], new_size: int) -> list[T]:
    """Deterministic even-spread downsampling (util.rs:31-44)."""
    size = len(vec)
    if size <= new_size:
        return vec
    out = []
    t = 0
    for x in vec:
        t = (t % size) + new_size
        if t >= size:
            out.append(x)
    return out


def array_segmenter(
    array: Sequence[T], exclude_func: Callable[[T], bool]
) -> Iterator[range]:
    """Yield ranges of non-excluded runs (util.rs:90-148)."""
    size = len(array)
    end = 0
    while end < size:
        start = end
        while start < size and exclude_func(array[start]):
            start += 1
        end = start
        while end < size and not exclude_func(array[end]):
            end += 1
        yield range(start, end)


def drop_true(vec: list[T], drop_list: Sequence[bool]) -> list[T]:
    """Drop entries flagged true (util.rs:151-155).  Returns a new list."""
    assert len(vec) == len(drop_list)
    return [x for x, d in zip(vec, drop_list) if not d]
