"""Small containers (reference lib/rust-vc-utils/src/containers.rs:5-111 parity)."""

from __future__ import annotations

import numpy as np


class RingBuffer:
    """Fixed-capacity ring buffer retaining the most recent pushes
    (containers.rs RingBuffer)."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self._data: list = [None] * capacity
        self._capacity = capacity
        self._size = 0
        self._head = 0  # index of oldest element

    def push(self, item) -> None:
        idx = (self._head + self._size) % self._capacity
        if self._size == self._capacity:
            self._data[self._head] = item
            self._head = (self._head + 1) % self._capacity
        else:
            self._data[idx] = item
            self._size += 1

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, i: int):
        if not 0 <= i < self._size:
            raise IndexError(i)
        return self._data[(self._head + i) % self._capacity]

    def to_list(self) -> list:
        return [self[i] for i in range(self._size)]


class SparseWindowSum:
    """Running sum over a sliding positional window with sparse updates
    (containers.rs SparseWindowSum)."""

    def __init__(self, window_size: int):
        assert window_size > 0
        self.window_size = window_size
        self._counts = np.zeros(window_size, dtype=np.int64)
        self._pos = 0
        self._sum = 0
        self._last_add: int | None = None

    def add(self, pos: int, value: int = 1) -> None:
        """Add at a strictly increasing absolute position (the reference
        asserts pos > last_pos, containers.rs push; an out-of-order add
        would land in a slot owned by a different absolute position)."""
        if self._last_add is not None and pos <= self._last_add:
            raise ValueError(
                f"SparseWindowSum positions must increase: {pos} after "
                f"{self._last_add}"
            )
        self._last_add = pos
        self.advance(max(pos - self.window_size + 1, self._pos))
        self._counts[pos % self.window_size] += value
        self._sum += value

    def advance(self, new_head: int) -> None:
        """Slide the window head forward, dropping positions that fall out."""
        steps = new_head - self._pos
        if steps <= 0:
            return
        if steps >= self.window_size:
            self._counts[:] = 0
            self._sum = 0
        else:
            for p in range(self._pos, new_head):
                i = p % self.window_size
                self._sum -= int(self._counts[i])
                self._counts[i] = 0
        self._pos = new_head

    def sum(self) -> int:
        return self._sum
