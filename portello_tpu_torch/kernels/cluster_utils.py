"""Batched indel-cluster machinery and the bounded-window common run.

Port of ``portello_tpu.kernels.cluster_utils`` (gather form) to PyTorch on
``(B, ...)`` tensors.  ``match_run_left``/``match_run_right`` are stage 4 of
the forward step; on CUDA tensors they launch the hand-written kernel in
``csrc/match_run.cu``, which takes the place of the TPU kernel
``portello_tpu.kernels.pallas.match_run_pallas.match_run_batch_pallas``.  On
CPU tensors they run the plain PyTorch version below, which indexes bytes
directly where the JAX gather path fetched 4-byte words.
"""

from __future__ import annotations

import torch

from portello_tpu_torch.kernels.cigar_kernels import (
    D,
    I,
    PAD,
    arange32,
    consumes_read,
    consumes_ref,
)

_I32 = torch.int32

# Bytes read outside a row: they differ, so out-of-row lanes never match.
FILL_A = 0xFE
FILL_B = 0xFD


def op_positions(codes, lens, ref_pos):
    """Per-op (ref_start, read_start) as exclusive prefix sums
    (vectorized update_ref_and_read_pos walk, cigar/mod.rs:70-78)."""
    rl = torch.where(consumes_ref(codes), lens, 0)
    dl = torch.where(consumes_read(codes), lens, 0)
    ref_starts = ref_pos[:, None] + torch.cumsum(rl, 1, dtype=_I32) - rl
    read_starts = torch.cumsum(dl, 1, dtype=_I32) - dl
    return ref_starts, read_starts


def find_clusters(codes, lens, ref_pos, max_clusters: int):
    """Detect indel clusters (maximal I/D runs) and reduce their stats.

    Returns a dict of per-cluster ``(B, max_clusters)`` tensors
    ``ref_start``/``read_start``/``del_len``/``ins_len``, per-op
    ``cluster_id`` (-1 for non-indel ops) and ``cluster_end``, plus
    ``n_clusters`` and ``overflow`` (more clusters than the static bound).
    """
    b, n = codes.shape
    dev = codes.device
    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    no = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    prev_indel = torch.cat([no, is_indel[:, :-1]], 1)
    next_indel = torch.cat([is_indel[:, 1:], no], 1)
    cluster_start = is_indel & ~prev_indel
    cluster_end = is_indel & ~next_indel
    cs = torch.cumsum(cluster_start.to(_I32), 1, dtype=_I32)
    cid = torch.where(is_indel, cs - 1, -1)
    n_clusters = cs[:, -1]
    overflow = n_clusters > max_clusters

    ref_starts, read_starts = op_positions(codes, lens, ref_pos)

    # cluster k starts at op starts[k] (binary search over the cluster-start
    # prefix sum); I/D sums are prefix-sum differences over
    # [starts[k], starts[k+1]).
    k = arange32(max_clusters, dev)
    cvalid = k[None, :] < n_clusters[:, None]
    del_src = torch.where((codes == D) & valid, lens, 0)
    ins_src = torch.where((codes == I) & valid, lens, 0)
    boundary_q = arange32(max_clusters + 1, dev).add_(1).expand(b, -1)
    sboth = torch.searchsorted(
        cs, boundary_q.contiguous(), right=False, out_int32=True
    ).long()
    safe_starts = torch.clamp(sboth[:, :-1], max=n - 1)
    zero = torch.zeros((b, 1), dtype=_I32, device=dev)
    ps_del = torch.cat([zero, torch.cumsum(del_src, 1, dtype=_I32)], 1)
    ps_ins = torch.cat([zero, torch.cumsum(ins_src, 1, dtype=_I32)], 1)
    pd = torch.gather(ps_del, 1, sboth)
    pi = torch.gather(ps_ins, 1, sboth)
    return {
        "ref_start": torch.where(cvalid, torch.gather(ref_starts, 1, safe_starts), 0),
        "read_start": torch.where(cvalid, torch.gather(read_starts, 1, safe_starts), 0),
        "del_len": torch.where(cvalid, pd[:, 1:] - pd[:, :-1], 0),
        "ins_len": torch.where(cvalid, pi[:, 1:] - pi[:, :-1], 0),
        "cluster_id": cid,
        "cluster_end": cluster_end,
        "n_clusters": n_clusters,
        "overflow": overflow,
    }


def _bytes_at(seq, pos, fill: int):
    """seq (B, L) uint8 read at pos (B, C, W); ``fill`` outside [0, L)."""
    b, length = seq.shape
    inside = (pos >= 0) & (pos < length)
    safe = pos.clamp(0, length - 1).reshape(b, -1).long()
    got = torch.gather(seq, 1, safe).reshape(pos.shape)
    return torch.where(inside, got, fill)


def match_run_plain(seq_a, start_a, seq_b, start_b, limit, window: int,
                    rev: bool):
    """Plain PyTorch version of the ``match_run`` kernel.

    seq_*: (B, L) uint8; start_*, limit: (B, C) int32.  Forward compares
    ``seq_a[start_a + t]`` with ``seq_b[start_b + t]``, backward
    ``seq_a[start_a - 1 - t]`` with ``seq_b[start_b - 1 - t]``; returns the
    (B, C) int32 count of leading equal t in [0, min(limit, window))."""
    t = arange32(window, seq_a.device)
    step = (-1 - t) if rev else t
    va = _bytes_at(seq_a, start_a[:, :, None] + step, FILL_A)
    vb = _bytes_at(seq_b, start_b[:, :, None] + step, FILL_B)
    eq = (t < limit[:, :, None]) & (va == vb)
    return torch.cumprod(eq.to(_I32), 2, dtype=_I32).sum(2, dtype=_I32)


def match_run_cuda(seq_a, start_a, seq_b, start_b, limit, window: int,
                   rev: bool):
    """Launch ``csrc/match_run.cu``; same contract as ``match_run_plain``.

    Raises on what the kernel does not take: a CPU tensor, another dtype or
    rank, a non-contiguous tensor, mismatched shapes or devices, a negative
    window."""
    from portello_tpu_torch.kernels import _cuda

    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _cuda.require(seq_a, "seq_a", torch.uint8, 2)
    _cuda.require(seq_b, "seq_b", torch.uint8, 2)
    for name, x in (("start_a", start_a), ("start_b", start_b),
                    ("limit", limit)):
        _cuda.require(x, name, _I32, 2)
        if x.shape != start_a.shape or x.shape[0] != seq_a.shape[0]:
            raise ValueError(f"{name} must be (B, C) matching the rows")
        if x.device != seq_a.device:
            raise ValueError(f"{name} must be on {seq_a.device}")
    if seq_b.shape[0] != seq_a.shape[0] or seq_b.device != seq_a.device:
        raise ValueError("seq_a and seq_b must share batch size and device")
    b, c = start_a.shape
    run = torch.empty((b, c), dtype=_I32, device=seq_a.device)
    lib = _cuda.get_lib()
    with torch.cuda.device(seq_a.device):
        rc = lib.ptt_match_run(
            seq_a.data_ptr(), seq_a.shape[1], seq_b.data_ptr(), seq_b.shape[1],
            start_a.data_ptr(), start_b.data_ptr(), limit.data_ptr(), b, c,
            window, 1 if rev else 0, run.data_ptr(), _cuda.stream_handle(),
        )
    _cuda.check(rc, "match_run")
    return run


def match_run(seq_a, start_a, seq_b, start_b, limit, window: int, rev: bool):
    """The window common run: kernel for CUDA tensors, plain for CPU."""
    if seq_a.is_cuda:
        return match_run_cuda(seq_a, start_a, seq_b, start_b, limit, window, rev)
    return match_run_plain(seq_a, start_a, seq_b, start_b, limit, window, rev)


def match_run_left(seq_a, idx_a, seq_b, idx_b, limit, window: int):
    """Forward common run: how many t in [0, limit) satisfy
    ``seq_a[idx_a + t] == seq_b[idx_b + t]``, scanning at most ``window``
    steps.  Returns (run (B, C), saturated (B, C)); ``saturated`` means the
    window ran out while still matching with ``limit`` unreached."""
    run = match_run(seq_a, idx_a, seq_b, idx_b, limit, window, rev=False)
    return run, (run >= window) & (limit > window)


def match_run_right(seq_a, end_a, seq_b, end_b, limit, window: int):
    """Backward common run: how many t in [0, limit) satisfy
    ``seq_a[end_a - 1 - t] == seq_b[end_b - 1 - t]``, scanning at most
    ``window`` steps."""
    run = match_run(seq_a, end_a, seq_b, end_b, limit, window, rev=True)
    return run, (run >= window) & (limit > window)
