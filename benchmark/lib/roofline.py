"""The yardstick of the hand kernels: the card's peak and the bytes each
launch must move.

The three kernels do a few integer operations per byte, far below the
card's rate, so bytes bound them all: each input read once, each output
written once, at the H100 SXM's HBM3 rate of 3.35 TB/s at its full 700 W
(NVIDIA's data sheet).  Where a kernel's traffic depends on the data (the
mixed clusters of kernel 3, the bases kernel 2 compares), only the part the
shapes fix is counted, so a share is a lower bound and never passes 100%.
"""

from __future__ import annotations

from benchmark.lib.buckets import BUCKETS

HBM_BYTES_PER_S = 3.35e12

# The device function of each hand kernel, as torch.profiler names it.
KERNELS = {
    "cleanup_and_compress": "cleanup_and_compress_kernel",
    "match_run": "match_run_kernel",
    "window_match": "window_runs_resident_kernel",
}


def compress_bytes(b: int, k: int, max_out: int) -> int:
    """Kernel 1: codes and lens in, codes and lens out, n_out, shift and
    overflow."""
    return b * k * 8 + b * max_out * 8 + b * 9


def window_resident_bytes(b: int, c: int) -> int:
    """Kernel 3 on resident slots: the mask and both outputs of every pair
    and each item's genome base (the windows of the mixed pairs left out)."""
    return 9 * b * c + 8 * b


def match_run_bytes(b: int, c: int) -> int:
    """Kernel 2: both starts, the limit and the run of every pair (the bases
    compared left out)."""
    return 16 * b * c


def batch_bytes(kind: str, bucket: int, b: int) -> dict[str, int]:
    """Bytes of each kernel's launches in one batch of ``kind`` (the native
    feed's step kinds: ``fwd_resident``, ``fwd`` on table slots, ``rev``)."""
    ops, blocks, _, clusters = BUCKETS[bucket]
    max_out = ops + 2 * blocks + 8
    rows = ops + blocks
    lift_finish = compress_bytes(b, 2 * rows, max_out) + compress_bytes(
        b, 2 * max_out, max_out)
    if kind == "fwd_resident":
        return {"cleanup_and_compress": lift_finish,
                "window_match": window_resident_bytes(b, clusters)}
    table = {"cleanup_and_compress": lift_finish,
             "match_run": 2 * match_run_bytes(b, clusters)}
    if kind == "fwd":
        return table
    # rev: stage A (kernel 2) and stage B (kernel 1 at K = 2n + 1), then
    # the forward step on table slots
    return {"cleanup_and_compress": table["cleanup_and_compress"]
            + compress_bytes(b, 2 * ops + 1, ops),
            "match_run": table["match_run"] + match_run_bytes(b, clusters)}
