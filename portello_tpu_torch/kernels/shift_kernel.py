"""Batched indel left shift, for reads on reverse-mapped contigs.

Port of ``portello_tpu.kernels.shift_kernel`` (gather form: ``_minplus_scan``,
``_shift_stage_a``, ``_shift_stage_b`` and ``left_shift_batch``; the ``mm``
branch stays out) to PyTorch on ``(B, ...)`` tensors.  It computes the
reference's ``left_shift_indels`` (shift_indels/left_shift_indels.rs:17-39,
cigar_indel_shifter.rs:10-165):

- stage A finds the indel clusters and each cluster's leftward homology run
  over a bounded window (``match_run_right``: on CUDA tensors the
  ``csrc/match_run.cu`` kernel, backward), and reads the per-cluster values
  back at op positions;
- stage B runs the builder's match-block accounting as a min-plus affine
  scan ``p_i = min(b_i, a_i + p_{i-1})`` in closed form (one prefix sum and
  one running minimum), emits two op slots per input op plus a trailing
  flush, and finishes with ``cleanup_and_compress`` (on CUDA tensors the
  ``csrc/compress.cu`` kernel) at K = 2 * n_ops + 1.

Coordinates: ``ref_pos`` is relative to ``ref_win`` (a window of the
reversed contig) and ``win_base`` is the window's absolute offset on that
contig, for the reference's absolute left-edge limit
(indel_breakend_homology.rs:33).  Items whose homology window saturated
with the true budget beyond it, with too many clusters, or whose shifted
cigar overflows ``max_out``, set ``fallback`` and are finished on host.
"""

from __future__ import annotations

import torch

from portello_tpu_torch.kernels.cigar_kernels import (
    D,
    I,
    M,
    PAD,
    cleanup_and_compress,
    is_align_match,
)
from portello_tpu_torch.kernels.cluster_utils import find_clusters, match_run_right

_I32 = torch.int32

# Stands for +inf in the min-plus scan; half of INT32_MAX so every sum of
# the scan stays inside int32.
_INF = (2**31 - 1) // 2


def _minplus_scan(a, b):
    """Inclusive scan of p_i = min(b_i, a_i + p_{i-1}), p_{-1} = +inf, along
    dim 1 of (B, n) int32 tensors: ``SA + cummin(b - SA)``, SA = cumsum(a)."""
    sa = torch.cumsum(a, 1, dtype=_I32)
    return sa + torch.cummin(b - sa, 1).values


def _full(like, value: int):
    return torch.full_like(like, value, dtype=_I32)


def homology_run_args(cl: dict, win_base):
    """The arguments of stage A's leftward homology run
    (indel_breakend_homology.rs:33-47), from ``find_clusters``' output: the
    (B, C) ends of the suffixes compared in the window and in the read,
    and the limit, the absolute distance to either sequence's start
    (``win_base + ref_start``, not window-relative, so up to the read's
    length)."""
    bs = cl["ref_start"]       # window-relative
    rs = cl["read_start"]
    max_left = torch.minimum(win_base[:, None] + bs, rs)
    return bs + cl["del_len"], rs + cl["ins_len"], max_left


def shift_stage_a(codes, lens, ref_pos, win_base, ref_win, read_seq, *,
                  max_clusters: int, window: int) -> dict:
    """Clusters, homology caps and the per-op scan inputs.

    codes/lens (B, n) int32, ref_pos/win_base (B,) int32, ref_win/read_seq
    (B, L) uint8.  Returns a dict of (B, n) per-op tensors and the (B,)
    cluster ``overflow`` flag."""
    cl = find_clusters(codes, lens, ref_pos, max_clusters)
    dl = cl["del_len"]
    il = cl["ins_len"]
    end_ref, end_read, max_left = homology_run_args(cl, win_base)
    h_run, sat = match_run_right(ref_win, end_ref, read_seq, end_read,
                                 max_left, window)
    has_indel = (dl + il) > 0
    h_cap = torch.minimum(h_run, max_left)

    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    is_m = is_align_match(codes) & valid
    is_other = valid & ~is_indel & ~is_m
    cend = cl["cluster_end"]
    # torch.gather raises on an out-of-range index where XLA clamps
    cid = torch.clamp(cl["cluster_id"], 0, max_clusters - 1).long()

    # the per-cluster values consumed at op positions, gathered together
    c_table = torch.stack(
        [h_cap, (sat & has_indel).to(_I32), max_left, il, dl], dim=2
    )
    cv = torch.gather(c_table, 1, cid[:, :, None].expand(-1, -1, 5))
    cap_at_op = cv[:, :, 0]

    # Per-op min-plus transforms: match op (len, +inf) accumulates, cluster
    # end (0, cap) clamps, another op (0, 0) flushes, the rest is identity.
    a = torch.where(is_m, lens, 0)
    b = torch.where(cend, cap_at_op,
                    torch.where(is_other, 0, _full(codes, _INF)))
    return {
        "a": a, "b": b, "cend": cend, "is_other": is_other,
        "ins_at_op": cv[:, :, 3], "del_at_op": cv[:, :, 4],
        "cap_at_op": cap_at_op, "fb_sat": cv[:, :, 1] > 0,
        "ml_at_op": cv[:, :, 2], "overflow": cl["overflow"],
    }


def shift_stage_b_emit(codes, lens, st, *, window: int):
    """Stage B up to the compress: the (B, 2n+1) int32 emission stream
    (codes, lens) and the (B,) fallback of the scan.

    Two slots per op: at a cluster end the preceding match run splits around
    the shifted indel (nImD order, cigar_indel_shifter.rs:140-147), with the
    [M][I][D] replacement spread over the cluster's last two rows; at an
    "other" op the match run flushes, then the op is copied.  The trailing
    slot flushes the last match run."""
    b_, n = codes.shape
    dev = codes.device
    cend = st["cend"]
    is_other = st["is_other"]

    # Exclusive scan: pending BEFORE each op, seeded by a leading (0, 0).
    zero = torch.zeros((b_, 1), dtype=_I32, device=dev)
    p = _minplus_scan(torch.cat([zero, st["a"]], 1),
                      torch.cat([zero, st["b"]], 1))
    pending_before = p[:, :n]
    pending_final = p[:, n]

    s = torch.minimum(st["cap_at_op"], pending_before)
    is_indel = ((codes == I) | (codes == D)) & (codes != PAD)
    no = torch.zeros((b_, 1), dtype=torch.bool, device=dev)
    pre_end = is_indel & torch.cat([cend[:, 1:], no], 1)
    prev_indel = torch.cat([no, is_indel[:, :-1]], 1)
    single = cend & ~prev_indel
    ins_l = st["ins_at_op"]
    del_l = st["del_at_op"]
    end_single = cend & single
    pad = _full(codes, PAD)
    ins_or_del = torch.where(ins_l > 0, I, _full(codes, D))
    e_codes = torch.stack(
        [
            torch.where(pre_end | end_single | is_other, M,
                        torch.where(cend, D, pad)),
            torch.where(
                pre_end, I,
                torch.where(end_single, ins_or_del,
                            torch.where(is_other, codes, PAD)),
            ),
        ],
        dim=2,
    )
    e_lens = torch.stack(
        [
            torch.where(
                pre_end | end_single, pending_before - s,
                torch.where(is_other, pending_before,
                            torch.where(cend, del_l, 0)),
            ),
            torch.where(
                pre_end, ins_l,
                torch.where(end_single, torch.where(ins_l > 0, ins_l, del_l),
                            torch.where(is_other, lens, 0)),
            ),
        ],
        dim=2,
    )
    # The builder pushes only nonzero segments (cigar_indel_shifter.rs:87-99,
    # :133-137); a zero-length M would wrongly stop the edge cleanup walk.
    # The "other" op itself (slot 1) stays even when zero-length.
    keep_zero = torch.stack([torch.zeros_like(is_other), is_other], 2)
    e_codes = torch.where((e_lens == 0) & ~keep_zero, PAD, e_codes)

    # Fallback: homology window saturated AND the true budget could exceed it.
    fb = cend & st["fb_sat"] & (
        torch.minimum(st["ml_at_op"], pending_before) > window
    )
    fallback = fb.any(1) | st["overflow"]

    # Final flush of the trailing match run (cigar_indel_shifter.rs:155-160),
    # pushed only when nonzero.
    tail_code = torch.where(pending_final > 0, M, pad[:, 0])
    flat_codes = torch.cat([e_codes.reshape(b_, 2 * n), tail_code[:, None]], 1)
    flat_lens = torch.cat([e_lens.reshape(b_, 2 * n), pending_final[:, None]], 1)
    return flat_codes, flat_lens, fallback


def shift_stage_b(codes, lens, ref_pos, st, *, window: int, max_out: int):
    """Min-plus scan, emissions and cleanup/compress over stage A's outputs.

    Returns (codes (B, max_out), lens, n_out (B,), ref_pos (B,), fallback
    (B,))."""
    flat_codes, flat_lens, fallback = shift_stage_b_emit(
        codes, lens, st, window=window
    )
    f_codes, f_lens, n_out, shift, c_overflow = cleanup_and_compress(
        flat_codes, flat_lens, max_out
    )
    return f_codes, f_lens, n_out, ref_pos + shift, fallback | c_overflow


def left_shift_batch(codes, lens, ref_pos, win_base, ref_win, read_seq, *,
                     max_clusters: int, window: int, max_out: int):
    """Vectorized left_shift_indels over a batch: stage A, then stage B.

    Returns (codes, lens, n_out, ref_pos, fallback), as the JAX package's
    ``left_shift_batch``."""
    st = shift_stage_a(codes, lens, ref_pos, win_base, ref_win, read_seq,
                       max_clusters=max_clusters, window=window)
    return shift_stage_b(codes, lens, ref_pos, st, window=window,
                         max_out=max_out)
