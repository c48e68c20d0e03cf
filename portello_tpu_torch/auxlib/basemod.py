"""5mC CpG base-modification decoding from MM/ML aux tags.

Behavioral equivalent of the reference basemod decoder
(reference lib/rust-vc-utils/src/bam_utils/basemod.rs:24-239): extracts
strand-normalized per-read CpG methylation probabilities.  Error codes match
the reference's Result::Err values (basemod.rs:86-92).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from portello_tpu_torch.io.bam import BamRecord
from portello_tpu_torch.ops.seq import comp


def decode_ml(ml: int) -> float:
    """ML byte -> probability at bin center (basemod.rs:24-28)."""
    return ml / 256.0 + 1.0 / 512.0


class CpGMethSkippedBaseMode(Enum):
    """Interpretation of bases skipped in the MM tag (basemod.rs:48-54)."""

    DEFAULT = 0
    UNKNOWN = 1   # '?'
    LOW_PROB = 2  # '.'


@dataclass
class CpgMethInfo:
    """(basemod.rs:56-72): key = fwd-strand C read position, value = prob."""

    pos_prob: dict[int, float] = field(default_factory=dict)
    skip_mode: CpGMethSkippedBaseMode = CpGMethSkippedBaseMode.DEFAULT


def _get_tag(rec: BamRecord, upper: bytes, mixed: bytes):
    got = rec.get_tag(upper)
    if got is None:
        got = rec.get_tag(mixed)
    return got


def decode_cpg_meth_info(record: BamRecord) -> CpgMethInfo | int:
    """Decode CpG 5mC probabilities; returns an int error code (1-5) mirroring
    the reference's Err values (basemod.rs:93-239)."""
    mm = _get_tag(record, b"MM", b"Mm")
    ml = _get_tag(record, b"ML", b"Ml")
    if mm is None or ml is None:
        return 1
    qname = record.qname.decode()
    mm_ty, mm_val = mm
    if mm_ty != b"Z":
        raise ValueError(f"Unexpected MM tag format in read {qname}: {mm_ty}")
    mm_str = mm_val.decode() if isinstance(mm_val, bytes) else mm_val
    if not mm_str:
        return 2

    ml_offset = 0
    offsets = None
    skip_mode = CpGMethSkippedBaseMode.DEFAULT
    for segment in mm_str.split(";"):
        if not segment and offsets is None:
            continue
        parts = segment.split(",")
        word = parts[0]
        if word.startswith("C+m"):
            offsets = [int(x) for x in parts[1:]]
            if any(o < 0 for o in offsets):
                # the reference parses offsets as usize (basemod.rs) — a
                # negative offset is a hard error, never negative indexing
                raise ValueError(
                    f"Invalid negative MM tag offset in bam record: {qname}"
                )
            if len(word) > 3:
                mode_ch = word[3]
                if mode_ch == "?":
                    skip_mode = CpGMethSkippedBaseMode.UNKNOWN
                elif mode_ch == ".":
                    skip_mode = CpGMethSkippedBaseMode.LOW_PROB
                else:
                    raise ValueError(
                        f"Unexpected MM tag format in read {qname}: {mm_str}"
                    )
            break
        ml_offset += len(parts) - 1
    if offsets is None:
        return 3
    if not offsets:
        return 4

    ml_ty, ml_val = ml
    if ml_ty != b"B" or ml_val[0] != b"C":
        raise ValueError(f"Unexpected ML tag format in read {qname}")
    ml_vals = np.asarray(ml_val[1])[ml_offset : ml_offset + len(offsets)]
    if len(ml_vals) != len(offsets):
        raise ValueError(
            f"Error: bam record C+m MM and ML counts disagree "
            f"({len(offsets)} vs {len(ml_vals)}) in bam record: {qname}"
        )

    # Offsets count skipped 'C' bases along the SEQUENCING-orientation read.
    read = record.seq
    if record.is_reverse():
        read = comp(read)[::-1]
    c_positions = np.flatnonzero(read == ord("C"))
    # cumulative walk: offset k means "skip k C's since the previous hit"
    idx = -1
    basemod_read_indexes = []
    for off in offsets:
        idx += off + 1
        if idx >= len(c_positions):
            raise ValueError(
                f"Read sequence is too short for MM tag offsets in bam "
                f"record: {qname}"
            )
        basemod_read_indexes.append(int(c_positions[idx]))

    info = CpgMethInfo(skip_mode=skip_mode)
    read_len = len(read)
    for read_index, ml_byte in zip(basemod_read_indexes, ml_vals):
        # Only CpG contexts (basemod.rs:216-219)
        if read_index + 1 >= read_len or read[read_index + 1] != ord("G"):
            continue
        ref_strand_read_index = read_index
        if record.is_reverse():
            # flip to the fwd-strand "C" of the CpG (basemod.rs:222-227)
            ref_strand_read_index = read_len - (read_index + 1) - 1
        info.pos_prob[ref_strand_read_index] = decode_ml(int(ml_byte))

    if not info.pos_prob:
        return 5
    return info
