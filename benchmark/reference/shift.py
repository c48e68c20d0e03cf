"""Left/right shifting of alignment indels to their homology limits (host oracle).

Behavioral equivalent of the reference's indel shifter
(reference lib/rust-vc-utils/src/bam_utils/cigar/shift_indels/): every indel
cluster is slid as far as its breakend homology allows, bounded by the adjacent
match run; fused clusters are always emitted in canonical "nImD" order, and the
result is edge-cleaned + compressed.  The M/=/X distinction is not preserved
(reference left_shift_indels.rs:6-12).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg
from benchmark.reference.homology import get_indel_breakend_homology_info

LEFT = 0
RIGHT = 1


class _ShiftBuilder:
    """Mirror of CigarShiftBuilder (shift_indels/cigar_indel_shifter.rs:10-165).

    For RIGHT shifts the caller feeds ops in reverse order with their original
    (ref_pos, read_pos) start coordinates; the output list is reversed at the end.
    """

    def __init__(self, direction: int, ref_seq: np.ndarray, read_seq: np.ndarray):
        self.dir = direction
        self.ref_seq = ref_seq
        self.read_seq = read_seq
        self.match_block = 0
        self.in_indel = False
        self.indel_ref_start = 0
        self.indel_read_start = 0
        self.indel_del = 0
        self.indel_ins = 0
        self.out: list[tuple[int, int]] = []

    def add_element(self, code: int, length: int, ref_pos: int, read_pos: int) -> None:
        if code == cg.D:
            self._add_del(length, ref_pos, read_pos)
        elif code == cg.I:
            self._add_ins(length, ref_pos, read_pos)
        elif cg.IS_ALIGN_MATCH[code]:
            self._add_match(length)
        else:
            self._add_other((code, length))

    def get_cigar(self) -> np.ndarray:
        self._add_other(None)
        if self.dir == RIGHT:
            self.out.reverse()
        if not self.out:
            return cg.EMPTY.copy()
        return np.array(self.out, dtype=np.int64)

    def _add_indel(self, ref_pos: int, read_pos: int) -> None:
        # For RIGHT shifts (reverse iteration) each new indel op RESETS the block
        # start coordinates, since earlier-seen ops sit later in the alignment
        # (cigar_indel_shifter.rs:63-71).
        if self.dir == RIGHT or not self.in_indel:
            self.indel_ref_start = ref_pos
            self.indel_read_start = read_pos
            self.in_indel = True

    def _add_del(self, length: int, ref_pos: int, read_pos: int) -> None:
        if length > 0:
            self._add_indel(ref_pos, read_pos)
            self.indel_del += length

    def _add_ins(self, length: int, ref_pos: int, read_pos: int) -> None:
        if length > 0:
            self._add_indel(ref_pos, read_pos)
            self.indel_ins += length

    def _end_indel(self) -> None:
        if not self.in_indel:
            return
        self.in_indel = False

        ref_range = (self.indel_ref_start, self.indel_ref_start + self.indel_del)
        read_range = (self.indel_read_start, self.indel_read_start + self.indel_ins)
        (left, right), _ = get_indel_breakend_homology_info(
            self.ref_seq, ref_range, self.read_seq, read_range
        )
        shift_len = max(0, -left if self.dir == LEFT else right)

        actual = min(self.match_block, shift_len)
        remaining = self.match_block - actual
        if remaining > 0:
            self.out.append((cg.M, remaining))
        self.match_block = actual

        # Canonical nImD output order (cigar_indel_shifter.rs:140-147).
        if self.dir == LEFT and self.indel_ins > 0:
            self.out.append((cg.I, self.indel_ins))
        if self.indel_del > 0:
            self.out.append((cg.D, self.indel_del))
        if self.dir == RIGHT and self.indel_ins > 0:
            self.out.append((cg.I, self.indel_ins))
        self.indel_ins = 0
        self.indel_del = 0

    def _add_match(self, length: int) -> None:
        self._end_indel()
        self.match_block += length

    def _add_other(self, seg: tuple[int, int] | None) -> None:
        self._end_indel()
        if self.match_block > 0:
            self.out.append((cg.M, self.match_block))
            self.match_block = 0
        if seg is not None:
            self.out.append(seg)


def left_shift_indels(
    ref_pos: int, cig: np.ndarray, ref_seq: np.ndarray, read_seq: np.ndarray
) -> tuple[int, np.ndarray]:
    """Left-shift all indels (shift_indels/left_shift_indels.rs:17-39).

    Returns ``(shifted_ref_pos, shifted_cigar)``.
    """
    builder = _ShiftBuilder(LEFT, ref_seq, read_seq)
    ref_starts, read_starts = cg.op_start_positions(cig, ref_pos, False)
    for (code, length), rp, dp in zip(cig, ref_starts, read_starts):
        builder.add_element(int(code), int(length), int(rp), int(dp))
    out = builder.get_cigar()
    out, shift = cg.clean_up_cigar_edge_indels(out)
    return ref_pos + shift, cg.compress_cigar(out)


def right_shift_indels(
    ref_pos: int, cig: np.ndarray, ref_seq: np.ndarray, read_seq: np.ndarray
) -> tuple[int, np.ndarray]:
    """Right-shift all indels (shift_indels/right_shift_indels.rs:20-50).

    Ref pos can still move due to edge-deletion cleanup.
    """
    builder = _ShiftBuilder(RIGHT, ref_seq, read_seq)
    ref_starts, read_starts = cg.op_start_positions(cig, ref_pos, False)
    for (code, length), rp, dp in zip(cig[::-1], ref_starts[::-1], read_starts[::-1]):
        builder.add_element(int(code), int(length), int(rp), int(dp))
    out = builder.get_cigar()
    out, shift = cg.clean_up_cigar_edge_indels(out)
    return ref_pos + shift, cg.compress_cigar(out)
