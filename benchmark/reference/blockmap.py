"""Read-to-reference block maps: the liftover index.

TPU-native replacement for the reference's ``ReadToRefTreeMap``
(reference lib/rust-vc-utils/src/bam_utils/read_to_ref_map.rs:59-137): instead of a
BTreeMap we keep two parallel sorted dense arrays (``keys`` = read positions
starting a block, ``vals`` = reference position at the block start or ``NONE`` for
unmapped gaps).  Floor lookups become ``searchsorted`` — the form that both the
numpy oracle and the JAX kernels share.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference import cigar as cg

#: Sentinel for "read position not mapped to the reference" (BAM ref positions are
#: always >= 0 so -1 is unambiguous).
NONE = -1


@dataclass
class BlockMap:
    """Sparse block map from read coordinate to reference coordinate.

    ``keys[i]`` is the read position where block ``i`` starts; ``vals[i]`` is the
    reference position of that block start, or :data:`NONE` when the block is an
    unmapped gap.  Keys are strictly increasing.
    """

    keys: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    vals: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))

    def __len__(self) -> int:
        return len(self.keys)

    def get_ref_pos(self, read_pos: int) -> int | None:
        """Map one read position to a reference position (or None).

        Mirrors ReadToRefTreeMap::get_ref_pos (read_to_ref_map.rs:67-72): floor
        lookup plus offset within the block.
        """
        i = int(np.searchsorted(self.keys, read_pos, side="right")) - 1
        if i < 0:
            return None
        v = int(self.vals[i])
        if v == NONE:
            return None
        return v + (read_pos - int(self.keys[i]))

    def get_ref_range(self, read_start: int, read_end: int) -> tuple[np.ndarray, np.ndarray]:
        """Entries intersecting ``[read_start, read_end)``, starting at the block
        enclosing ``read_start``.

        Mirrors ReadToRefTreeMap::get_ref_range (read_to_ref_map.rs:74-85): the
        range begins at the greatest key <= read_start when one exists, else at
        read_start itself.
        """
        lo = int(np.searchsorted(self.keys, read_start, side="right")) - 1
        if lo < 0:
            lo = 0
        hi = int(np.searchsorted(self.keys, read_end, side="left"))
        return self.keys[lo:hi], self.vals[lo:hi]

    def window(self, lo_idx: int, hi_idx: int) -> "BlockMap":
        return BlockMap(self.keys[lo_idx:hi_idx], self.vals[lo_idx:hi_idx])

    def range_indices(self, read_start: int, read_end: int) -> tuple[int, int]:
        """Index bounds of :meth:`get_ref_range` (for device window gathers)."""
        lo = int(np.searchsorted(self.keys, read_start, side="right")) - 1
        if lo < 0:
            lo = 0
        hi = int(np.searchsorted(self.keys, read_end, side="left"))
        return lo, hi


def build_block_map(ref_pos: int, cig: np.ndarray, ignore_hard_clip: bool) -> BlockMap:
    """Build the block map for an alignment, vectorized.

    Behavioral equivalent of get_read_segment_to_ref_pos_tree_map
    (read_to_ref_map.rs:101-137): for every maximal run of M/=/X ops a
    ``(run_read_start -> run_ref_start)`` entry plus a ``(run_read_end -> NONE)``
    gap entry; later entries overwrite earlier ones at the same key (a pure
    deletion between two runs leaves no gap entry).
    """
    n = len(cig)
    if n == 0:
        return BlockMap()
    codes = cig[:, 0]
    am = cg.IS_ALIGN_MATCH[codes]
    if not am.any():
        return BlockMap()
    ref_starts, read_starts = cg.op_start_positions(cig, ref_pos, ignore_hard_clip)
    ref_ends = ref_starts + cg.ref_lens(cig)
    read_ends = read_starts + cg.read_lens(cig, ignore_hard_clip)

    # Maximal runs of alignment-match ops.
    run_start = am.copy()
    run_start[1:] &= ~am[:-1]
    run_end = am.copy()
    run_end[:-1] &= ~am[1:]
    starts = np.flatnonzero(run_start)
    ends = np.flatnonzero(run_end)
    # Total match length per run must be > 0 to emit (read_to_ref_map.rs:112-119).
    match_lens = read_ends[ends] - read_starts[starts]
    keep = match_lens > 0
    starts = starts[keep]
    ends = ends[keep]
    if len(starts) == 0:
        return BlockMap()

    keys = np.empty(2 * len(starts), dtype=np.int64)
    vals = np.empty(2 * len(starts), dtype=np.int64)
    keys[0::2] = read_starts[starts]
    vals[0::2] = ref_starts[starts]
    keys[1::2] = read_ends[ends]
    vals[1::2] = NONE

    # BTreeMap insert overwrites: keep the LAST entry at each duplicate key.
    if len(keys) > 1:
        last = np.ones(len(keys), dtype=bool)
        last[:-1] = keys[:-1] != keys[1:]
        keys = keys[last]
        vals = vals[last]
    return BlockMap(keys, vals)


def build_dense_read_to_ref_map(
    seq_len: int, ref_pos: int, cig: np.ndarray, ignore_hard_clip: bool
) -> np.ndarray:
    """Dense per-read-position map to reference positions (NONE where unmapped).

    Equivalent of get_read_segment_to_ref_pos_map (read_to_ref_map.rs:17-41).  The
    dense form is the natural TPU layout; provided for library parity and tests.
    """
    out = np.full(seq_len, NONE, dtype=np.int64)
    ref_starts, read_starts = cg.op_start_positions(cig, ref_pos, ignore_hard_clip)
    for (code, length), rs, ds in zip(cig, ref_starts, read_starts):
        if cg.IS_ALIGN_MATCH[code]:
            out[ds : ds + length] = np.arange(rs, rs + length, dtype=np.int64)
    return out
