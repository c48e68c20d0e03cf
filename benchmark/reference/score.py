"""Alignment scoring: edit distance and gap-compressed identity.

Behavioral equivalent of the reference scoring routines
(reference lib/rust-vc-utils/src/bam_utils/cigar/score_alignment.rs:10-165).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg


class AlignMatchError(ValueError):
    """Raised by the ``_no_align_match`` variants when an M op is present
    (score_alignment.rs:56-59, :155-158)."""


def get_edit_distance(
    ref_pos: int, cig: np.ndarray, read_seq: np.ndarray, ref_seq: np.ndarray
) -> int:
    """Edit distance; works with M or =/X CIGARs (score_alignment.rs:10-41)."""
    dist = 0
    read_pos = 0
    rp = int(ref_pos)
    for code, length in cig:
        code = int(code)
        length = int(length)
        if code in (cg.I, cg.D, cg.N, cg.X):
            dist += length
        elif code == cg.M:
            ref_arr = np.asarray(ref_seq)
            read_arr = np.asarray(read_seq)
            if rp + length > len(ref_arr):
                # reference slices ref_seq[pos..pos+len] exactly -> panic
                raise IndexError(
                    "ref_seq shorter than the CIGAR's reference span"
                )
            # read side mirrors the reference's zip over read_seq[read_pos..]:
            # a short read truncates the comparison instead of erroring
            # (read_pos beyond the end would panic there too)
            if read_pos > len(read_arr):
                raise IndexError("read_seq shorter than the CIGAR read span")
            k = min(length, len(read_arr) - read_pos)
            dist += int(
                np.count_nonzero(
                    ref_arr[rp : rp + k] != read_arr[read_pos : read_pos + k]
                )
            )
        rp += int(cg.CONSUMES_REF[code]) * length
        read_pos += int(cg.CONSUMES_READ_HARD[code]) * length
    return dist


def get_edit_distance_no_align_match(cig: np.ndarray) -> int:
    """Edit distance from an =/X CIGAR alone (score_alignment.rs:47-66)."""
    dist = 0
    for code, length in cig:
        code = int(code)
        if code in (cg.I, cg.D, cg.N, cg.X):
            dist += int(length)
        elif code == cg.M:
            raise AlignMatchError(
                "Method assumes alignment CIGAR strings use seq match/mismatch "
                "(=/X) instead of alignment match (M)"
            )
    return dist


def _final_gci(match_bases: int, mismatch_events: int) -> float:
    """(score_alignment.rs:68-74)"""
    if match_bases + mismatch_events == 0:
        return 1.0
    return match_bases / (match_bases + mismatch_events)


def get_gap_compressed_identity(
    ref_pos: int, cig: np.ndarray, read_seq: np.ndarray, ref_seq: np.ndarray
) -> float:
    """Gap-compressed identity (lh3 definition); works with M or =/X CIGARs
    (score_alignment.rs:83-129)."""
    mismatch_events = 0
    match_bases = 0
    read_pos = 0
    rp = int(ref_pos)
    for code, length in cig:
        code = int(code)
        length = int(length)
        if code in (cg.I, cg.D):
            mismatch_events += 1
        elif code == cg.X:
            mismatch_events += length
        elif code == cg.EQ:
            match_bases += length
        elif code == cg.M:
            eq = np.asarray(ref_seq)[rp : rp + length] == np.asarray(read_seq)[
                read_pos : read_pos + length
            ]
            match_bases += int(np.count_nonzero(eq))
            mismatch_events += int(length - np.count_nonzero(eq))
        rp += int(cg.CONSUMES_REF[code]) * length
        read_pos += int(cg.CONSUMES_READ_HARD[code]) * length
    return _final_gci(match_bases, mismatch_events)


def get_gap_compressed_identity_no_align_match(cig: np.ndarray) -> float:
    """Gap-compressed identity from an =/X CIGAR alone
    (score_alignment.rs:138-165).  Note: N counts as one mismatch event here."""
    mismatch_events = 0
    match_bases = 0
    for code, length in cig:
        code = int(code)
        if code in (cg.I, cg.D, cg.N):
            mismatch_events += 1
        elif code == cg.X:
            mismatch_events += int(length)
        elif code == cg.EQ:
            match_bases += int(length)
        elif code == cg.M:
            raise AlignMatchError(
                "Method assumes alignment CIGAR strings use seq match/mismatch "
                "(=/X) instead of alignment match (M)"
            )
    return _final_gci(match_bases, mismatch_events)
