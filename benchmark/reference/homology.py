"""Indel breakend homology: how far an indel can slide without changing edit
distance.

Behavioral equivalent of get_indel_breakend_homology_info
(reference lib/rust-vc-utils/src/indel_breakend_homology.rs:24-73).
"""

from __future__ import annotations

import numpy as np


def get_indel_breakend_homology_info(
    ref_seq: np.ndarray,
    ref_range: tuple[int, int],
    read_seq: np.ndarray,
    read_range: tuple[int, int],
) -> tuple[tuple[int, int], np.ndarray]:
    """Return ``((left, right), homology_seq)`` where ``[left, right]`` is the
    offset interval (relative to the current indel position) preserving edit
    distance; ``left <= 0 <= right``.

    ``ref_range``/``read_range`` are the (start, end) spans of the indel in each
    coordinate system, starting at the first affected position (e.g. 2M1D2M ->
    ref (2,3), read (2,2)).
    """
    ref_start, ref_end = int(ref_range[0]), int(ref_range[1])
    read_start, read_end = int(read_range[0]), int(read_range[1])

    hom: list[int] = []

    # Leftward translation limit.
    max_left = min(ref_start, read_start)
    left = 0
    while left < max_left:
        rb = ref_seq[ref_end - left - 1]
        db = read_seq[read_end - left - 1]
        if rb != db:
            break
        hom.append(int(rb))
        left += 1
    hom.reverse()

    # Rightward translation limit.
    max_right = min(len(ref_seq) - ref_end, len(read_seq) - read_end)
    right = 0
    while right < max_right:
        rb = ref_seq[ref_start + right]
        db = read_seq[read_start + right]
        if rb != db:
            break
        hom.append(int(rb))
        right += 1

    return (-left, right), np.array(hom, dtype=np.uint8)
