"""Alignment clipping by read-length or reference-length from either edge.

Behavioral equivalent of the reference clipping facilities
(reference lib/rust-vc-utils/src/bam_utils/cigar/clip_alignment.rs:15-181): soft
clip at least the requested amount; insertions on the clip boundary are clipped
entirely, dangling edge deletions are removed; results are compressed.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg


def _clip_start(cig: np.ndarray, min_clip: int, by_ref: bool) -> tuple[np.ndarray, int]:
    """Single left-edge clip pass (clip_alignment.rs:15-68 for by_ref,
    :103-156 for by-read)."""
    ref_pos = 0
    read_pos = 0
    out: list[tuple[int, int]] = []
    ref_shift = 0
    for code, length in cig:
        code = int(code)
        length = int(length)
        pos = ref_pos if by_ref else read_pos
        if code in (cg.D, cg.N):
            if pos <= min_clip:
                ref_shift += length
            else:
                out.append((code, length))
        elif code == cg.I:
            if pos < min_clip:
                out.append((cg.S, length))
            else:
                out.append((code, length))
        elif cg.IS_ALIGN_MATCH[code]:
            if pos < min_clip:
                # by_ref uses the accumulated shift, by-read the read pos, to
                # compute the remaining clip (clip_alignment.rs:43, :131).
                remaining = min_clip - (ref_shift if by_ref else read_pos)
                match_size = max(length - remaining, 0)
                clip_size = length - match_size
                out.append((cg.S, clip_size))
                if match_size > 0:
                    out.append((code, match_size))
                ref_shift += clip_size
            else:
                out.append((code, length))
        else:
            out.append((code, length))
        ref_pos += int(cg.CONSUMES_REF[code]) * length
        read_pos += int(cg.CONSUMES_READ_HARD[code]) * length
    arr = np.array(out, dtype=np.int64) if out else cg.EMPTY.copy()
    return arr, ref_shift


def _clip_edges(
    cig: np.ndarray, min_left: int, min_right: int, by_ref: bool
) -> tuple[np.ndarray, int]:
    right_clipped, _ = _clip_start(cig[::-1], min_right, by_ref)
    both, ref_shift = _clip_start(right_clipped[::-1], min_left, by_ref)
    return cg.compress_cigar(both), ref_shift


def clip_alignment_ref_edges(
    cig: np.ndarray, min_left_ref_clip: int, min_right_ref_clip: int
) -> tuple[np.ndarray, int]:
    """Soft-clip to shift the reference start/end by at least the given amounts
    (clip_alignment.rs:78-93).  Returns (cigar, actual ref start shift)."""
    return _clip_edges(cig, min_left_ref_clip, min_right_ref_clip, by_ref=True)


def clip_alignment_read_edges(
    cig: np.ndarray, min_left_clip: int, min_right_clip: int
) -> tuple[np.ndarray, int]:
    """Soft-clip at least the given number of read bases from each edge
    (clip_alignment.rs:166-181).  Returns (cigar, ref start shift)."""
    return _clip_edges(cig, min_left_clip, min_right_clip, by_ref=False)
