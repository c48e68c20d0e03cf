"""Exact host-side liftover of a read alignment through a block map.

Behavioral equivalent of the reference's liftover core
(reference src/liftover_read_alignment.rs:35-223).  A frozen copy of the
port's host oracle.

Coordinate conventions: the read aligns to "ref1" (an assembly contig) with
``ref1_pos`` + ``ref1_cigar``; ``ref1_to_ref2_map`` maps ref1 coordinates onto
"ref2" (the reference genome).  Output is ``(ref2_pos, ref2_cigar)`` or None when
no read base lands on ref2.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import cigar as cg
from benchmark.reference.blockmap import NONE, BlockMap


def liftover_read_alignment(
    ref1_to_ref2_map: BlockMap,
    ref1_pos: int,
    ref1_cigar: np.ndarray,
) -> tuple[int, np.ndarray] | None:
    """Lift a read->ref1 alignment over to ref2.

    Mirrors liftover_read_alignment (liftover_read_alignment.rs:137-223): read-only
    ops (I/S/H) copy through; ref-consuming ops (M/=/X/D/N) are re-segmented
    against the ref1->ref2 blocks overlapping their ref1 interval; Pad is dropped.
    Returns None when the alignment never reaches a mapped ref2 block via an
    alignment-match op.
    """
    ref2_start_pos: int | None = None
    ref2_end_pos: int | None = None
    out_codes: list[int] = []
    out_lens: list[int] = []

    seg_start = int(ref1_pos)
    for code, length in ref1_cigar:
        code = int(code)
        length = int(length)
        if code in (cg.I, cg.S, cg.H):
            out_codes.append(code)
            out_lens.append(length)
        elif code == cg.P:
            pass
        else:  # M / = / X / D / N : re-segment against the block map
            seg_end = seg_start + length
            is_match = bool(cg.IS_ALIGN_MATCH[code])
            block_ref1_pos = seg_start
            keys, vals = ref1_to_ref2_map.get_ref_range(seg_start, seg_end)

            last: tuple[int, int] | None = None
            # One extra iteration with this_block=None closes out the op
            # (liftover_read_alignment.rs:202-211).
            for i in range(len(keys) + 1):
                this_key = int(keys[i]) if i < len(keys) else None

                # --- update_ref2_cigar_segment (liftover_read_alignment.rs:35-133)
                end = seg_end if this_key is None else min(this_key, seg_end)
                if end > block_ref1_pos:
                    seg_len = end - block_ref1_pos
                    if last is None:
                        # Before any ref1->ref2 mapping: read bases become clip.
                        if is_match:
                            out_codes.append(cg.S)
                            out_lens.append(seg_len)
                    else:
                        last_key, last_val = last
                        if last_val == NONE:
                            # ref1 bases deleted in ref2: read bases become Ins.
                            if is_match:
                                out_codes.append(cg.I)
                                out_lens.append(seg_len)
                        else:
                            if is_match and ref2_start_pos is None:
                                ref2_start_pos = last_val + (block_ref1_pos - last_key)
                            # ref2-only gap since the previous mapped block -> Del.
                            if ref2_end_pos is not None:
                                deletion_len = last_val - ref2_end_pos
                                if deletion_len > 0 and ref2_start_pos is not None:
                                    out_codes.append(cg.D)
                                    out_lens.append(deletion_len)
                            ref2_end_pos = last_val + (end - last_key)
                            if is_match or ref2_start_pos is not None:
                                if code == cg.D:
                                    out_codes.append(cg.D)
                                elif code == cg.N:
                                    out_codes.append(cg.N)
                                else:
                                    # M/=/X all re-emit as plain M.
                                    out_codes.append(cg.M)
                                out_lens.append(seg_len)
                    block_ref1_pos = end
                # --- end update_ref2_cigar_segment

                if this_key is not None:
                    last = (this_key, int(vals[i]))

        seg_start += int(cg.CONSUMES_REF[code]) * length

    if ref2_start_pos is None:
        return None
    out = np.array(list(zip(out_codes, out_lens)), dtype=np.int64)
    if len(out) == 0:
        out = cg.EMPTY.copy()
    out, shift = cg.clean_up_cigar_edge_indels(out)
    return ref2_start_pos + shift, cg.compress_cigar(out)
