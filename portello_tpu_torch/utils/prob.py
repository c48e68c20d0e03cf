"""Probability utilities (reference lib/rust-vc-utils/src/prob_util.rs:9-51 parity)."""

from __future__ import annotations

import numpy as np


def log_sum_exp(vals: np.ndarray) -> float:
    """Numerically stable log(sum(exp(vals)))."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.size == 0:
        return float("-inf")
    m = vals.max()
    if not np.isfinite(m):
        return float(m)
    return float(m + np.log(np.exp(vals - m).sum()))


def normalize_ln_distro(vals: np.ndarray) -> tuple[np.ndarray, int | None]:
    """Normalize a log-space distribution to sum to one in linear space.

    Mirrors reference norm_ln_distro (prob_util.rs:21-50) bit-for-bit:
    returns ``(probs, max_element)`` where ``max_element`` is the FIRST
    most-probable component index (None for an empty input), and the
    normalization is ``exp(v - max) * (1 / sum)`` — the reference's exact
    float operation order, not a log-space subtraction."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.size == 0:
        return vals.copy(), None
    max_element = int(np.argmax(vals))  # numpy argmax is first-max
    shifted = np.exp(vals - vals[max_element])
    inv = 1.0 / _seq_sum(shifted)
    return shifted * inv, max_element


def _seq_sum(arr: np.ndarray) -> float:
    """Sequential left-to-right f64 sum (the reference's accumulation
    order; numpy's pairwise sum can differ in the last ulp)."""
    total = 0.0
    for v in arr:
        total += float(v)
    return total
