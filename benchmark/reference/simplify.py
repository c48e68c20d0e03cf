"""Post-liftover canonicalization of indel clusters (host oracle).

Behavioral equivalent of the reference's simplify_alignment_indels
(reference src/simplify_alignment_indels.rs:4-156): every contiguous run of I/D ops
is consolidated — pure runs collapse, a 1D+1I residue becomes 1M, and otherwise
equal bases are greedily re-matched against the actual ref/read sequence (right
edge first, then left edge), with the residue emitted in canonical "nImD" order.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg


def _end_indel(
    ref_seq: np.ndarray,
    read_seq: np.ndarray,
    block_ref_start: int,
    block_read_start: int,
    del_len: int,
    ins_len: int,
) -> list[tuple[int, int]]:
    """Simplified replacement for one indel cluster
    (simplify_alignment_indels.rs:35-111)."""
    if del_len == 0 and ins_len == 0:
        return []
    if del_len == 0:
        return [(cg.I, ins_len)]
    if ins_len == 0:
        return [(cg.D, del_len)]
    if del_len == 1 and ins_len == 1:
        # SNP-like: prefer 1 edit over 2 without looking at sequence.
        return [(cg.M, 1)]

    pre_match = 0
    post_match = 0
    # Push as much as possible onto the right-side match state first.
    while del_len > 0 and ins_len > 0:
        if (
            ref_seq[block_ref_start + del_len - 1]
            == read_seq[block_read_start + ins_len - 1]
        ):
            del_len -= 1
            ins_len -= 1
            post_match += 1
        else:
            break
    # Then onto the left-side match state.
    while del_len > 0 and ins_len > 0:
        if (
            ref_seq[block_ref_start + pre_match]
            == read_seq[block_read_start + pre_match]
        ):
            del_len -= 1
            ins_len -= 1
            pre_match += 1
        else:
            break
    # Final SNP preference.
    if del_len == 1 and ins_len == 1:
        del_len = 0
        ins_len = 0
        post_match += 1

    out = []
    if pre_match:
        out.append((cg.M, pre_match))
    if ins_len:
        out.append((cg.I, ins_len))
    if del_len:
        out.append((cg.D, del_len))
    if post_match:
        out.append((cg.M, post_match))
    return out


def simplify_alignment_indels(
    ref_pos: int,
    cig: np.ndarray,
    ref_seq: np.ndarray,
    read_seq: np.ndarray,
) -> tuple[int, np.ndarray]:
    """Canonicalize all indel clusters in an alignment
    (simplify_alignment_indels.rs:119-156).

    ``ref_seq``/``read_seq`` are uint8 base arrays; ``ref_pos`` indexes ``ref_seq``
    directly (pass a window plus window-relative position for large genomes).
    Returns ``(new_ref_pos, new_cigar)``.
    """
    ref_head = int(ref_pos)
    read_head = 0
    in_block = False
    block_ref_start = 0
    block_read_start = 0
    block_del = 0
    block_ins = 0
    out: list[tuple[int, int]] = []

    for code, length in cig:
        code = int(code)
        length = int(length)
        if code == cg.D or code == cg.I:
            if not in_block:
                in_block = True
                block_ref_start = ref_head
                block_read_start = read_head
            if code == cg.D:
                block_del += length
            else:
                block_ins += length
        else:
            if in_block:
                out.extend(
                    _end_indel(
                        ref_seq, read_seq, block_ref_start, block_read_start,
                        block_del, block_ins,
                    )
                )
                in_block = False
                block_del = 0
                block_ins = 0
            out.append((code, length))
        ref_head += int(cg.CONSUMES_REF[code]) * length
        read_head += int(cg.CONSUMES_READ_HARD[code]) * length

    if in_block:
        out.extend(
            _end_indel(
                ref_seq, read_seq, block_ref_start, block_read_start,
                block_del, block_ins,
            )
        )

    arr = np.array(out, dtype=np.int64) if out else cg.EMPTY.copy()
    arr, shift = cg.clean_up_cigar_edge_indels(arr)
    return ref_pos + shift, cg.compress_cigar(arr)
