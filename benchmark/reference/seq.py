"""DNA sequence utilities (vectorized).

Behavioral equivalent of the reference seq utilities
(reference lib/rust-vc-utils/src/seq_util.rs:1-40): complements ACGTacgt
preserving case; everything else complements to N.
"""

from __future__ import annotations

import numpy as np

_COMP_LUT = np.full(256, ord("N"), dtype=np.uint8)
for a, b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"), ("N", "N")]:
    _COMP_LUT[ord(a)] = ord(b)
    _COMP_LUT[ord(a.lower())] = ord(b.lower())


def comp_base(x: int) -> int:
    """Complement one base (seq_util.rs:1-15)."""
    return int(_COMP_LUT[x])


def comp(seq: np.ndarray) -> np.ndarray:
    """Complement a uint8 base array."""
    return _COMP_LUT[np.asarray(seq, dtype=np.uint8)]


def rev_comp(seq: np.ndarray | bytes) -> np.ndarray:
    """Reverse-complement (seq_util.rs:21-23)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return _COMP_LUT[arr][::-1].copy()


def to_bytes(seq: np.ndarray) -> bytes:
    return np.asarray(seq, dtype=np.uint8).tobytes()


def from_bytes(seq: bytes | str) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return np.frombuffer(seq, dtype=np.uint8).copy()
