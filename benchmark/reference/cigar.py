"""CIGAR algebra over dense ``(code, len)`` op tensors.

Behavioral equivalent of the reference CIGAR toolkit
(reference lib/rust-vc-utils/src/bam_utils/cigar/mod.rs:1-327); every public
function cites the reference routine it mirrors.

A CIGAR is an ``int64`` numpy array of shape ``(n, 2)``: column 0 the BAM numeric op
code, column 1 the op length.  The numeric codes follow the BAM spec ("MIDNSHP=X"),
so this tensor is exactly what the raw BAM record encodes and what the device
kernels consume.
"""

from __future__ import annotations

import numpy as np

# BAM op codes (SAM spec section 4.2; same order the reference's htslib layer uses)
M = 0  # alignment match (can be sequence match or mismatch)
I = 1  # noqa: E741  insertion to the reference
D = 2  # deletion from the reference
N = 3  # skipped region from the reference
S = 4  # soft clipping
H = 5  # hard clipping
P = 6  # padding
EQ = 7  # sequence match
X = 8  # sequence mismatch

#: Device-side padding code for fixed-shape op tensors (no meaning in BAM).
PAD = 9

OP_CHARS = "MIDNSHP=X"
_CHAR_TO_CODE = {c: i for i, c in enumerate(OP_CHARS)}

# Per-code consumption tables (reference cigar/mod.rs:26-47).
# read: I, S, M, =, X consume read; H consumes read unless ignore_hard_clip.
CONSUMES_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0], dtype=np.int64)
CONSUMES_READ_HARD = np.array([1, 1, 0, 0, 1, 1, 0, 1, 1, 0], dtype=np.int64)
# ref: M, D, N, =, X consume reference.
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0], dtype=np.int64)
# alignment-match codes M/=/X (reference cigar/mod.rs:22-24)
IS_ALIGN_MATCH = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1, 0], dtype=np.bool_)
# clip codes S/H (reference cigar/mod.rs:16-18)
IS_CLIP = np.array([0, 0, 0, 0, 1, 1, 0, 0, 0, 0], dtype=np.bool_)

EMPTY = np.zeros((0, 2), dtype=np.int64)


def cigar(*pairs) -> np.ndarray:
    """Build a CIGAR tensor from ``(code, len)`` tuples (test convenience)."""
    if not pairs:
        return EMPTY.copy()
    return np.array(pairs, dtype=np.int64)


def from_string(cigar_str: str) -> np.ndarray:
    """Parse a CIGAR text string into the dense tensor form.

    Equivalent of the reference's get_cigar_from_string (cigar/mod.rs:193-197).
    '*' parses to the empty cigar.
    """
    if cigar_str in ("", "*"):
        return EMPTY.copy()
    out = []
    num = 0
    have_num = False
    for ch in cigar_str:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            have_num = True
        else:
            code = _CHAR_TO_CODE.get(ch)
            if code is None or not have_num:
                raise ValueError(f"Malformed CIGAR string: {cigar_str!r}")
            out.append((code, num))
            num = 0
            have_num = False
    if have_num:
        raise ValueError(f"Malformed CIGAR string (trailing number): {cigar_str!r}")
    return np.array(out, dtype=np.int64) if out else EMPTY.copy()


def to_string(cig: np.ndarray) -> str:
    """Format a CIGAR tensor as text ('*' when empty)."""
    if len(cig) == 0:
        return "*"
    return "".join(f"{int(l)}{OP_CHARS[int(c)]}" for c, l in cig)


def is_alignment_match(code: int) -> bool:
    """True for M/=/X (reference cigar/mod.rs:22-24)."""
    return bool(IS_ALIGN_MATCH[code])


def is_clip(code: int) -> bool:
    """True for S/H (reference cigar/mod.rs:16-18)."""
    return bool(IS_CLIP[code])


def read_lens(cig: np.ndarray, ignore_hard_clip: bool) -> np.ndarray:
    """Per-op read-length consumption (reference cigar/mod.rs:26-39)."""
    tab = CONSUMES_READ if ignore_hard_clip else CONSUMES_READ_HARD
    if len(cig) == 0:
        return np.zeros(0, dtype=np.int64)
    return tab[cig[:, 0]] * cig[:, 1]


def ref_lens(cig: np.ndarray) -> np.ndarray:
    """Per-op reference-length consumption (reference cigar/mod.rs:41-47)."""
    if len(cig) == 0:
        return np.zeros(0, dtype=np.int64)
    return CONSUMES_REF[cig[:, 0]] * cig[:, 1]


def get_cigar_read_offset(cig: np.ndarray, ignore_hard_clip: bool) -> int:
    """Total read length of the alignment (reference cigar/mod.rs:164-170)."""
    return int(read_lens(cig, ignore_hard_clip).sum())


def get_cigar_ref_offset(cig: np.ndarray) -> int:
    """Total reference span of the alignment (reference cigar/mod.rs:174-180)."""
    return int(ref_lens(cig).sum())


def get_cigar_ref_and_read_offset(
    cig: np.ndarray, ignore_hard_clip: bool
) -> tuple[int, int]:
    """(ref span, read length) of the alignment (reference cigar/mod.rs:153-160)."""
    return get_cigar_ref_offset(cig), get_cigar_read_offset(cig, ignore_hard_clip)


def get_read_clip_positions(
    cig: np.ndarray, ignore_hard_clip: bool
) -> tuple[int, int, int]:
    """(end of left clipping, start of right clipping, read length) in read coords.

    Mirrors reference get_read_clip_positions (cigar/mod.rs:85-118): left clip is the
    run of S (and H unless ignored) ops before the first non-clip op; right clip the
    corresponding suffix run.
    """
    n = len(cig)
    read_len = get_cigar_read_offset(cig, ignore_hard_clip)
    if n == 0:
        return 0, 0, 0
    codes = cig[:, 0]
    lens = cig[:, 1]
    clip_mask = IS_CLIP[codes] if not ignore_hard_clip else codes == S
    # The reference's `left_clip` flag (cigar/mod.rs:92-114) stays true until the
    # first non-clip op; every counted clip op after that point (including interior
    # ones in pathological cigars) accumulates into the right clip.
    nonclip = np.flatnonzero(~IS_CLIP[codes])
    left_end = int(nonclip[0]) if len(nonclip) else n
    count = lens * clip_mask
    left_clip = int(count[:left_end].sum())
    right_clip = int(count[left_end:].sum())
    return left_clip, read_len - right_clip, read_len


def get_read_hard_clip_positions(cig: np.ndarray) -> tuple[int, int, int]:
    """Like :func:`get_read_clip_positions` but only hard clips count as clipping
    (reference cigar/mod.rs:125-149); read length includes hard clips.
    """
    n = len(cig)
    read_len = get_cigar_read_offset(cig, ignore_hard_clip=False)
    if n == 0:
        return 0, 0, 0
    codes = cig[:, 0]
    lens = cig[:, 1]
    hard = codes == H
    nonhard = np.flatnonzero(~hard)
    left_end = int(nonhard[0]) if len(nonhard) else n
    count = lens * hard
    left_clip = int(count[:left_end].sum())
    right_clip = int(count[left_end:].sum())
    return left_clip, read_len - right_clip, read_len


def is_hard_clipped(cig: np.ndarray) -> bool:
    """True if the alignment has any hard clip ops (reference cigar/mod.rs:184-186)."""
    return len(cig) > 0 and bool(np.any(cig[:, 0] == H))


def has_aligned_segments(cig: np.ndarray) -> bool:
    """True if the CIGAR has any M/=/X op (reference cigar/mod.rs:295-297)."""
    return len(cig) > 0 and bool(np.any(IS_ALIGN_MATCH[cig[:, 0]]))


def compress_cigar(cig: np.ndarray) -> np.ndarray:
    """Canonicalize: drop zero-length ops, merge adjacent ops of the same code.

    Mirrors reference compress_cigar (cigar/mod.rs:204-228): zero-length elements are
    removed *before* run merging, so they never split a run.
    """
    if len(cig) == 0:
        return EMPTY.copy()
    kept = cig[cig[:, 1] != 0]
    if len(kept) == 0:
        return EMPTY.copy()
    codes = kept[:, 0]
    new_run = np.ones(len(kept), dtype=bool)
    new_run[1:] = codes[1:] != codes[:-1]
    run_ids = np.cumsum(new_run) - 1
    n_runs = int(run_ids[-1]) + 1
    out = np.zeros((n_runs, 2), dtype=np.int64)
    out[:, 0] = codes[new_run]
    np.add.at(out[:, 1], run_ids, kept[:, 1])
    # Reference quirk (cigar/mod.rs:210-215): the run-merge if-let arm omits
    # Cigar::Pad, so an adjacent-Pad run keeps only its FIRST length (3P4P ->
    # 3P).  Unreachable through phase 2 (liftover drops Pad,
    # liftover_read_alignment.rs:213); mirrored for phase-1/library parity.
    pad_runs = out[:, 0] == P
    if pad_runs.any():
        out[pad_runs, 1] = kept[new_run, 1][pad_runs]
    return out


def _edge_regions(codes: np.ndarray) -> tuple[int, int]:
    """Indices delimiting the leading/trailing non-alignment-match edge regions.

    Returns (first_match_idx, last_match_idx) with the take_while semantics of the
    reference edge walkers (cigar/mod.rs:241-251, :278-288): when no alignment match
    exists, both walks cover the whole array.
    """
    am = IS_ALIGN_MATCH[codes]
    idx = np.flatnonzero(am)
    if len(idx) == 0:
        return len(codes), -1
    return int(idx[0]), int(idx[-1])


def cigar_edge_insertion_to_softclip(cig: np.ndarray) -> np.ndarray:
    """Convert insertions on either alignment edge to soft clip.

    Mirrors reference cigar_edge_insertion_to_softclip (cigar/mod.rs:234-252); the
    edge is everything before the first / after the last M/=/X op.  Returns a new
    array (the reference mutates in place).
    """
    out = cig.copy()
    if len(out) == 0:
        return out
    first, last = _edge_regions(out[:, 0])
    idx = np.arange(len(out))
    edge = (idx < first) | (idx > last)
    ins = edge & (out[:, 0] == I)
    out[ins, 0] = S
    return out


def clean_up_cigar_edge_indels(cig: np.ndarray) -> tuple[np.ndarray, int]:
    """Normalize edge indels: edge Ins -> SoftClip, edge Del -> zero-length SoftClip.

    Mirrors reference clean_up_cigar_edge_indels (cigar/mod.rs:265-291).  Returns
    ``(new_cigar, leading_del_shift)`` where the shift is the total leading-edge
    deletion length removed (the alignment start must advance by this much).  Meant
    to be followed by :func:`compress_cigar`.
    """
    out = cig.copy()
    if len(out) == 0:
        return out, 0
    first, last = _edge_regions(out[:, 0])
    idx = np.arange(len(out))
    lead = idx < first
    trail = idx > last
    edge = lead | trail
    del_mask = edge & (out[:, 0] == D)
    ins_mask = edge & (out[:, 0] == I)
    del_shift = int(out[lead & (out[:, 0] == D), 1].sum())
    out[del_mask, 0] = S
    out[del_mask, 1] = 0
    out[ins_mask, 0] = S
    return out, del_shift


def strip_leading_clip(cig: np.ndarray) -> np.ndarray:
    """Remove all leading S/H ops (reference cigar/mod.rs:300-312)."""
    if len(cig) == 0:
        return cig.copy()
    nonclip = np.flatnonzero(~IS_CLIP[cig[:, 0]])
    start = int(nonclip[0]) if len(nonclip) else len(cig)
    return cig[start:].copy()


def strip_trailing_clip(cig: np.ndarray) -> np.ndarray:
    """Remove clip ops per reference cigar/mod.rs:315-327 retain semantics:
    EVERY clip after the first non-clip element is dropped (interior clips
    too, not just the trailing run), and an all-clip cigar is returned
    unchanged (``non_clip_found`` never fires there)."""
    if len(cig) == 0:
        return cig.copy()
    clip = IS_CLIP[cig[:, 0]]
    nonclip = np.flatnonzero(~clip)
    if len(nonclip) == 0:
        return cig.copy()
    keep = (np.arange(len(cig)) <= int(nonclip[0])) | ~clip
    return cig[keep].copy()


def reverse_cigar(cig: np.ndarray) -> np.ndarray:
    """Reverse op order (strand flip helper; reference read_alignment_scanner.rs:167)."""
    return cig[::-1].copy()


def op_start_positions(
    cig: np.ndarray, ref_pos: int, ignore_hard_clip: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Vector of (ref_pos, read_pos) at the *start* of each op.

    The tensorized form of the reference's update_ref_and_read_pos walk
    (cigar/mod.rs:70-78): exclusive prefix sums of per-op consumption.
    """
    n = len(cig)
    ref_starts = np.zeros(n, dtype=np.int64)
    read_starts = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(ref_lens(cig)[:-1], out=ref_starts[1:])
        np.cumsum(read_lens(cig, ignore_hard_clip)[:-1], out=read_starts[1:])
        ref_starts += ref_pos
    return ref_starts, read_starts
