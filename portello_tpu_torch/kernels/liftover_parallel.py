"""Batched data-parallel liftover (gather form).

Port of ``portello_tpu.kernels.liftover_parallel._liftover_parallel_single``
to PyTorch on ``(B, ...)`` tensors.  The reference's nested walk over cigar
ops and map blocks (src/liftover_read_alignment.rs:137-223) is an interval
join over a static update grid of ``U`` rows per item:

1. Row -> (op, visit) from a prefix sum of per-op visit counts and one
   ``searchsorted``.
2. Per-row interval bounds, active map entry and emissions are gathers and
   elementwise ops.
3. The cross-row state — "has the alignment started" and "ref2 end of the
   previous mapped visit" — is an argmax and an exclusive running maximum of
   the packed ``(row << 17) | rel_end2``.

This stage has no TPU kernel; it stays PyTorch ops.
"""

from __future__ import annotations

import torch

from portello_tpu_torch.kernels.cigar_kernels import (
    D,
    H,
    I,
    INT32_MAX,
    M,
    N,
    PAD,
    S,
    arange32,
    consumes_ref,
    exclusive_cummax,
    is_align_match,
)

_I32 = torch.int32


def _take(table, idx):
    """table (B, R, F) gathered at idx (B, U) -> (B, U, F)."""
    f = table.shape[2]
    return torch.gather(table, 1, idx.long()[:, :, None].expand(-1, -1, f))


def liftover_batch(ops, lens, n_ops, ref1_pos, bk, bv, nb,
                   max_rows: int | None = None):
    """Lift a batch of read->contig cigars through contig->ref block maps.

    ops/lens: (B, max_ops) int32; n_ops, ref1_pos, nb: (B,) int32; bk/bv:
    (B, max_blocks) int32 map keys (INT32_MAX-padded) and values (-1 gaps).
    Returns (emit_codes (B, 2U), emit_lens (B, 2U), ref2_start (B,),
    row_overflow (B,)) with 2 emission slots per update row.  ``max_rows``
    overrides the worst-case grid height ``2*max_ops + max_blocks``; items
    needing more rows set ``row_overflow`` and are finished on host.
    """
    b, max_ops = ops.shape
    max_blocks = bk.shape[1]
    dev = ops.device
    U = max_rows if max_rows else 2 * max_ops + max_blocks

    active = arange32(max_ops, dev)[None, :] < n_ops[:, None]
    codes = torch.where(active, ops, PAD)
    lens_ = torch.where(active, lens, 0)

    is_ro = (codes == I) | (codes == S) | (codes == H)
    rc = consumes_ref(codes) & active

    # Op ref1 intervals.
    rl = torch.where(rc, lens_, 0)
    s = ref1_pos[:, None] + torch.cumsum(rl, 1, dtype=_I32) - rl
    e = s + rl

    # Block entry range per rc op (get_ref_range floor semantics).
    lo_raw = torch.searchsorted(bk, s, right=True, out_int32=True)
    hi = torch.minimum(
        torch.searchsorted(bk, e, right=False, out_int32=True), nb[:, None]
    )
    # ``pre``: the op starts before the first map key — only then is the
    # reference's first visit (leading SoftClip) a real update, so rows are
    # numbered from the first REAL visit: visits = hi - lo + pre.
    pre = (lo_raw == 0).to(_I32)
    lo = torch.minimum(torch.clamp(lo_raw - 1, min=0), hi)

    visits = torch.where(
        rc, hi - lo + pre, (is_ro & active).to(_I32)
    )
    cs_visits = torch.cumsum(visits, 1, dtype=_I32)
    off = cs_visits - visits                 # exclusive row offset per op
    total_rows = cs_visits[:, -1]

    # Row -> (op, visit index).  Rows past total_rows expand to op
    # max_ops-1's values; every consumer below masks with row_valid.
    r = arange32(U, dev)
    row_valid = r[None, :] < total_rows[:, None]
    op_table = torch.stack(
        [codes, lens_, rc.to(_I32), is_ro.to(_I32), s, lo, off, pre], dim=2
    )
    op_of = torch.clamp(
        torch.searchsorted(
            cs_visits, r.expand(b, U).contiguous(), right=True, out_int32=True
        ),
        max=max_ops - 1,
    )
    row_vals = _take(op_table, op_of)
    code_r = row_vals[..., 0]
    len_r = row_vals[..., 1]
    rc_r = (row_vals[..., 2] > 0) & row_valid
    ro_r = (row_vals[..., 3] > 0) & row_valid
    s_r = row_vals[..., 4]
    e_r = s_r + row_vals[..., 2] * len_r     # e = s + ref_len (rc ops only)
    lo_r = row_vals[..., 5]
    t = r[None, :] - row_vals[..., 6]
    pre_r = row_vals[..., 7]

    # this/last map entries: visit t is the reference's visit t + 1 - pre;
    # "this" = lo + t + 1 - pre, "last" = this - 1; past the window "this"
    # reads as +inf.
    bkv = torch.stack([bk, bv], dim=2)
    this_idx = lo_r + t + 1 - pre_r
    last_idx = this_idx - 1
    this_key = _take(bkv, torch.clamp(this_idx, 0, max_blocks - 1))[..., 0]
    last_kv = _take(bkv, torch.clamp(last_idx, 0, max_blocks - 1))
    last_key = last_kv[..., 0]
    last_val = last_kv[..., 1]
    this_key = torch.where(this_idx < nb[:, None], this_key, INT32_MAX)
    have_last = t >= pre_r

    # Interval [Bg, E) processed by this update.
    Bg = torch.where(
        have_last, torch.maximum(s_r, torch.minimum(last_key, e_r)), s_r
    )
    E = torch.minimum(this_key, e_r)
    L = E - Bg
    do_upd = rc_r & (L > 0)

    is_m = is_align_match(code_r)
    mapped_last = do_upd & have_last & (last_val >= 0)
    gap_last = do_upd & have_last & (last_val < 0)
    no_last = do_upd & ~have_last

    # --- alignment start: the first update with a mapped last + match op
    # (liftover_read_alignment.rs:84-88)
    start_mask = mapped_last & is_m
    any_start = start_mask.any(1)
    r_star = start_mask.to(_I32).argmax(1, keepdim=True)
    at = torch.gather(last_val + (Bg - last_key), 1, r_star)[:, 0]
    ref2_start = torch.where(any_start, at, -1)
    started = any_start[:, None] & (r[None, :] >= r_star)

    # --- gap deletions: previous mapped visit's ref2 end vs this block's
    # val (liftover_read_alignment.rs:91-100), as ONE packed int32 exclusive
    # cummax: (row << 17) | (end2 - window_floor).  end2 - floor is within
    # the item's ref2 window span (<= max_seq <= 2^16 by the buckets); a
    # defensive overflow flag backstops out-of-contract inputs.
    end2 = last_val + (E - last_key)
    base = torch.where(bv >= 0, bv, INT32_MAX).amin(1, keepdim=True)
    rel_end2 = end2 - base
    pack_ovf = (mapped_last & (rel_end2 >= (1 << 17))).any(1)
    pack = torch.where(mapped_last, (r[None, :] << 17) | rel_end2, -1)
    prev_pack = exclusive_cummax(pack)
    have_end = mapped_last & (prev_pack >= 0)
    prev_end2 = base + (prev_pack & ((1 << 17) - 1))
    del_len = last_val - prev_end2
    emit_del = have_end & (del_len > 0) & started

    # --- emissions
    seg_code = torch.where(
        code_r == D, D, torch.where(code_r == N, N, torch.full_like(code_r, M))
    )
    emit_seg = mapped_last & (is_m | started)
    emit_clip = no_last & is_m
    emit_ins = gap_last & is_m

    pad = torch.full_like(code_r, PAD)
    e0_code = torch.where(emit_del, D, pad)
    e0_len = torch.where(emit_del, del_len, 0)
    e1_code = torch.where(
        ro_r,
        code_r,
        torch.where(
            emit_clip, S,
            torch.where(emit_ins, I, torch.where(emit_seg, seg_code, pad)),
        ),
    )
    e1_len = torch.where(
        ro_r, len_r, torch.where(emit_clip | emit_ins | emit_seg, L, 0)
    )

    emit_codes = torch.stack([e0_code, e1_code], dim=2).reshape(b, 2 * U)
    emit_lens = torch.stack([e0_len, e1_len], dim=2).reshape(b, 2 * U)
    row_overflow = (total_rows > U) | pack_ovf
    return emit_codes, emit_lens, ref2_start, row_overflow
