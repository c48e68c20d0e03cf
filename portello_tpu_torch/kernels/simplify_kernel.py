"""Batched indel-cluster simplification (gather form).

Port of ``portello_tpu.kernels.simplify_kernel`` — ``_cluster_cases``,
``_simplify_single`` (its ``mm=False`` branch) and ``_finish_from_runs`` —
to PyTorch on ``(B, ...)`` tensors.  The reference's greedy per-base re-match
loops (simplify_alignment_indels.rs:54-92) become two bounded-window common
runs (``match_run_right`` then ``match_run_left``); a window saturation sets
the per-item ``fallback`` flag and the item is finished exactly on host.

Coordinates: ``ref_pos`` is relative to the item's ``ref_win`` row (table
slots) or to its global genome offset ``g_base`` (resident slots).
"""

from __future__ import annotations

import torch

from portello_tpu_torch.kernels.cigar_kernels import (
    D,
    I,
    M,
    PAD,
    arange32,
    cleanup_and_compress,
)
from portello_tpu_torch.kernels.cluster_utils import (
    find_clusters,
    match_run_left,
    match_run_right,
)
from portello_tpu_torch.kernels.window_match import window_runs_resident

_I32 = torch.int32


def _cluster_cases(codes, lens, ref_pos, max_clusters: int):
    """find_clusters + the reference's case split (rs:41-49): pure and 1/1
    clusters bypass sequence inspection; only MIXED clusters (both I and D)
    need sequence windows."""
    cl = find_clusters(codes, lens, ref_pos, max_clusters)
    dl = cl["del_len"]
    il = cl["ins_len"]
    cvalid = (
        arange32(max_clusters, codes.device)[None, :] < cl["n_clusters"][:, None]
    )
    pure = (dl == 0) | (il == 0)
    one_one = (dl == 1) & (il == 1)
    mixed = cvalid & ~pure & ~one_one
    return cl, cvalid, pure, one_one, mixed


def simplify_batch(codes, lens, ref_pos, ref_win, read_seq, *, max_clusters,
                   window, max_out):
    """simplify_alignment_indels over a batch.

    codes/lens: (B, K) int32 lifted cigars; ref_pos: (B,) int32 relative to
    ``ref_win``; ref_win/read_seq: (B, max_seq) uint8.  Returns (codes
    (B, max_out), lens, n_out (B,), ref_pos (B,), fallback (B,)); items with
    ``fallback`` set must be recomputed exactly on host."""
    cl, cvalid, pure, one_one, mixed = _cluster_cases(
        codes, lens, ref_pos, max_clusters
    )
    dl = cl["del_len"]
    il = cl["ins_len"]
    bs = cl["ref_start"]
    rs = cl["read_start"]
    # Right-edge greedy re-match (rs:54-68), then left-edge (rs:71-85).  The
    # limit-capped runs equal min(raw, limit) (the compare stops at the
    # limit), so they feed _finish_from_runs directly.
    m0 = torch.minimum(dl, il)
    raw_r, _ = match_run_right(ref_win, bs + dl, read_seq, rs + il, m0, window)
    raw_l, _ = match_run_left(
        ref_win, bs, read_seq, rs, m0 - torch.minimum(raw_r, m0), window
    )
    return _finish_from_runs(
        codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed, raw_r, raw_l,
        max_clusters=max_clusters, window=window, max_out=max_out,
    )


def simplify_batch_resident(codes, lens, ref_pos, genome, g_base, read_packed,
                            *, max_clusters, window, max_out):
    """``simplify_batch`` with the genome resident and the read rows packed
    (the JAX package's ``simplify_batch_compact_resident``).

    genome: (N,) uint8 flat genome; g_base: (B,) int64 global byte offset
    that ``ref_pos`` is relative to; read_packed: (B, Lp) uint8 BAM nibble
    rows.  The raw runs of every mixed cluster come from one window-runs
    launch and take no limit; ``_finish_from_runs`` caps them.  The JAX
    package's batch compaction (``_compact_core``) is not carried over, so
    every mixed cluster gets its runs and the items flagged here are a
    subset of those the JAX resident step flags."""
    cl, cvalid, pure, one_one, mixed = _cluster_cases(
        codes, lens, ref_pos, max_clusters
    )
    raw_r, raw_l = window_runs_resident(
        genome, g_base, read_packed, cl["ref_start"], cl["read_start"],
        cl["del_len"], cl["ins_len"], mixed, window,
    )
    return _finish_from_runs(
        codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed, raw_r, raw_l,
        max_clusters=max_clusters, window=window, max_out=max_out,
    )


def _finish_from_runs(codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed,
                      raw_r, raw_l, *, max_clusters, window, max_out):
    """Case arithmetic + emission + compress given the per-cluster runs."""
    b, n = codes.shape
    dev = codes.device
    dl = cl["del_len"]
    il = cl["ins_len"]
    m0 = torch.minimum(dl, il)
    post = torch.minimum(raw_r, m0)
    sat_post = (raw_r >= window) & (m0 > window)
    dl1 = dl - post
    il1 = il - post
    m1 = torch.minimum(dl1, il1)
    pre = torch.minimum(raw_l, m1)
    sat_pre = (raw_l >= window) & (m1 > window)
    dl2 = dl1 - pre
    il2 = il1 - pre
    # Final SNP preference (rs:87-92).
    snp = (dl2 == 1) & (il2 == 1)
    post_f = post + snp.to(_I32)
    dl2 = torch.where(snp, 0, dl2)
    il2 = torch.where(snp, 0, il2)

    # Per-cluster emission, canonical nImD order: [M pre][I][D][M post].
    def const(v):
        return torch.full_like(dl, v)

    pad = const(PAD)
    c_codes = torch.stack(
        [
            torch.where(mixed, M, pad),
            torch.where(mixed | pure, I, torch.where(one_one, M, pad)),
            const(D),
            torch.where(mixed, M, pad),
        ],
        dim=2,
    )
    c_lens = torch.stack(
        [
            torch.where(mixed, pre, 0),
            torch.where(
                mixed, il2, torch.where(pure, il, one_one.to(_I32))
            ),
            torch.where(mixed, dl2, torch.where(pure, dl, 0)),
            torch.where(mixed, post_f, 0),
        ],
        dim=2,
    )
    c_codes = torch.where(cvalid[:, :, None], c_codes, PAD)
    c_lens = torch.where(cvalid[:, :, None], c_lens, 0)
    # The reference pushes only nonzero elements (rpush, rs:95-99).
    c_codes = torch.where(c_lens == 0, PAD, c_codes)

    # Reassemble: pass-through ops emit themselves; the cluster replacement
    # [M pre][I][D][M post] is split across the cluster's last two rows —
    # [M pre, I] at the second-to-last, [D, M post] at the last (single-op
    # clusters emit [I, D] from their one row).  Two emission slots per op.
    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    cend = cl["cluster_end"]
    cid = torch.clamp(cl["cluster_id"], 0, max_clusters - 1)
    no = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    pre_end = is_indel & torch.cat([cend[:, 1:], no], 1)
    prev_indel = torch.cat([no, is_indel[:, :-1]], 1)
    single = cend & ~prev_indel
    c_packed = torch.cat([c_codes, c_lens], dim=2)          # (B, C, 8)
    cv = torch.gather(c_packed, 1, cid.long()[:, :, None].expand(b, n, 8))
    # column pair: pre_end -> (0,1); single-op end -> (1,2); multi-op end -> (2,3)

    def pick(lo):
        return torch.where(
            pre_end, cv[..., lo],
            torch.where(single, cv[..., lo + 1], cv[..., lo + 2]),
        )

    emit = pre_end | cend
    passthru = valid & ~is_indel
    out_codes = torch.stack(
        [
            torch.where(passthru, codes, torch.where(emit, pick(0), PAD)),
            torch.where(emit, pick(1), PAD),
        ],
        dim=2,
    ).reshape(b, 2 * n)
    out_lens = torch.stack(
        [
            torch.where(passthru, lens, torch.where(emit, pick(4), 0)),
            torch.where(emit, pick(5), 0),
        ],
        dim=2,
    ).reshape(b, 2 * n)

    f_codes, f_lens, n_out, shift, c_overflow = cleanup_and_compress(
        out_codes, out_lens, max_out
    )
    fallback = (
        (mixed & (sat_post | sat_pre)).any(1) | cl["overflow"] | c_overflow
    )
    return f_codes, f_lens, n_out, ref_pos + shift, fallback
