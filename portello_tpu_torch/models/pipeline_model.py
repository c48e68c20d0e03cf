"""The device steps and the Python-feed batch engine.

Port of ``portello_tpu.models.pipeline_model`` as batched PyTorch functions:

- the forward step, liftover -> cleanup+compress -> indel simplify
  (``_lift_core``, ``_fwd_item``, ``fwd_batch`` with ``mm=False`` and
  ``fwd_batch_resident``);
- the reverse step ``rev_batch``: the indel left shift on the reversed
  contig (``kernels/shift_kernel.py``), then the forward step;
- ``DeviceEngine``, the batching executor of the Python feed, whose groups
  run as compiled steps (``group_rows``, ``group_inputs``, ``group_step``).

Under host-shift routing (``PTPU_HOST_SHIFT``, on by default) every batch,
forward or reverse contig, runs one forward step: ``fwd_batch_resident`` in
resident slot mode (the default of the native feed), ``fwd_batch`` on table
slots.  Under device-shift routing (``PTPU_HOST_SHIFT=0``) reverse-contig
batches run ``rev_batch``.  A step runs on whatever device its input
tensors live on: on CUDA, cleanup+compress and the window runs are the
hand-written kernels; on the CPU, their plain PyTorch versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels.cigar_kernels import (
    INT32_MAX,
    PAD,
    cigar_read_len,
    cleanup_and_compress,
)
from portello_tpu_torch.kernels.liftover_parallel import liftover_batch
from portello_tpu_torch.kernels.resident import global_base
from portello_tpu_torch.kernels.shift_kernel import shift_stage_a, shift_stage_b
from portello_tpu_torch.kernels.simplify_kernel import (
    simplify_batch,
    simplify_batch_resident,
)
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.ops import cigar as cg
from portello_tpu_torch.ops.blockmap import NONE
from portello_tpu_torch.ops.seq import rev_comp
from portello_tpu_torch.pipeline.read_scan import (
    finish_lifted_record,
    finish_remapped_alignment_set,
    get_contig_split_segments_from_read_mapping,
    get_liftover_alignment_for_read_and_contig_segment,
)
from portello_tpu_torch.pipeline.split_read import get_seq_order_read_split_segments

DEFAULT_BUCKETS = (
    # Tight HiFi primary bucket (p99 of the 18-24 kb profile), a mid spill
    # bucket and a wide one; anything beyond is finished on the exact host
    # path.  Equal field for field to portello_tpu's table.
    BucketConfig(max_ops=128, max_blocks=48, max_seq=24576, max_clusters=96, window=48),
    BucketConfig(max_ops=256, max_blocks=96, max_seq=24576, max_clusters=160, window=48),
    BucketConfig(max_ops=1024, max_blocks=384, max_seq=65536, max_clusters=512, window=48),
)

# Positional inputs of fwd_batch and their dtypes.
FWD_FIELDS = (
    ("ops", torch.int32), ("lens", torch.int32), ("n_ops", torch.int32),
    ("pos", torch.int32), ("bk", torch.int32), ("bv", torch.int32),
    ("nb", torch.int32), ("ref_win", torch.uint8), ("ref_base", torch.int32),
    ("read_seq", torch.uint8),
)

# Positional inputs of fwd_batch_resident (the genome follows them).
RESIDENT_FIELDS = (
    ("ops", torch.int32), ("lens", torch.int32), ("n_ops", torch.int32),
    ("pos", torch.int32), ("bk", torch.int32), ("bv", torch.int32),
    ("nb", torch.int32), ("g_sb", torch.int32), ("g_off", torch.int32),
    ("ref_base", torch.int32), ("read_packed", torch.uint8),
)

# Positional inputs of rev_batch: fwd_batch's, with the reversed contig's
# window (``contig_win``) and its offset on the contig (``win_base``).
REV_FIELDS = FWD_FIELDS[:4] + (
    ("win_base", torch.int32), ("contig_win", torch.uint8),
) + FWD_FIELDS[4:]


def _tensors(arrays, fields, device) -> tuple[torch.Tensor, ...]:
    if len(arrays) != len(fields):
        raise ValueError(f"expected {len(fields)} arrays, got {len(arrays)}")
    out = []
    for a, (name, dtype) in zip(arrays, fields):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        out.append(t.to(device))
    return tuple(out)


def batch_from_numpy(arrays, device) -> tuple[torch.Tensor, ...]:
    """The JAX step's numpy inputs (``fwd_batch``'s positional tuple) as the
    port's tensors on ``device``.  CPU tensors alias the numpy buffers."""
    return _tensors(arrays, FWD_FIELDS, device)


def rev_batch_from_numpy(arrays, device) -> tuple[torch.Tensor, ...]:
    """``rev_batch``'s numpy inputs as the port's tensors on ``device``.
    CPU tensors alias the numpy buffers."""
    return _tensors(arrays, REV_FIELDS, device)


def resident_batch_from_numpy(arrays, device) -> tuple[torch.Tensor, ...]:
    """``fwd_batch_resident``'s numpy inputs (without the genome) as the
    port's tensors on ``device``.  CPU tensors alias the numpy buffers."""
    return _tensors(arrays, RESIDENT_FIELDS, device)


def lift_core(ops, lens, n_ops, pos, bk, bv, nb, *, max_out, max_rows=None):
    """Liftover + cleanup/compress at the lift site (K = 2 * grid rows)."""
    e_codes, e_lens, ref2_start, row_ovf = liftover_batch(
        ops, lens, n_ops, pos, bk, bv, nb, max_rows
    )
    l_codes, l_lens, l_n, shift, overflow = cleanup_and_compress(
        e_codes, e_lens, max_out
    )
    mapped = ref2_start >= 0
    ref2_pos = torch.where(mapped, ref2_start + shift, -1)
    return l_codes, l_lens, l_n, ref2_pos, mapped, overflow | row_ovf


def _step(ops, lens, n_ops, pos, bk, bv, nb, ref_base, simplify, *, max_out,
          max_rows) -> dict:
    """Lift, then ``simplify(codes, lens, ref_pos)`` with ``ref_pos``
    relative to ``ref_base``; the output dict of both forward steps."""
    l_codes, l_lens, l_n, ref2_pos, mapped, overflow = lift_core(
        ops, lens, n_ops, pos, bk, bv, nb, max_out=max_out, max_rows=max_rows
    )
    read_len = cigar_read_len(l_codes, l_lens)
    s_codes, s_lens, s_n, s_pos_rel, s_fb = simplify(
        l_codes, l_lens, ref2_pos - ref_base
    )
    return {
        "codes": s_codes, "lens": s_lens, "n_out": s_n,
        "ref2_pos": s_pos_rel + ref_base, "mapped": mapped,
        "read_len": read_len,
        "fallback": s_fb | overflow,
    }


def fwd_batch(ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq,
              *, max_out, max_clusters, window, max_rows=None) -> dict:
    """The forward step over one batch of table slots.

    Returns a dict of (B, ...) tensors: ``codes``/``lens`` (B, max_out)
    int32, ``n_out``, ``ref2_pos``, ``read_len`` int32, ``mapped`` and
    ``fallback`` bool.  Items with ``fallback`` are finished on host."""
    return _step(
        ops, lens, n_ops, pos, bk, bv, nb, ref_base,
        lambda c, l, p: simplify_batch(
            c, l, p, ref_win, read_seq, max_clusters=max_clusters,
            window=window, max_out=max_out,
        ),
        max_out=max_out, max_rows=max_rows,
    )


def fwd_batch_resident(ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off,
                       ref_base, read_packed, genome, *, max_out, max_clusters,
                       window, max_rows=None) -> dict:
    """The forward step over one batch of resident slots.

    The same positional inputs as the JAX package's ``fwd_batch_resident``:
    ``g_sb``/``g_off`` (B,) int32 locate each item's window origin
    (``ref_base``) in the genome as (superblock, residue) and join into an
    int64 byte offset here; ``read_packed`` is (B, Lp) uint8 BAM nibbles;
    ``genome`` is the flat (N,) uint8 resident genome.  Returns the dict of
    ``fwd_batch``, equal to it on the paired table inputs."""
    g_base = global_base(g_sb, g_off)
    return _step(
        ops, lens, n_ops, pos, bk, bv, nb, ref_base,
        lambda c, l, p: simplify_batch_resident(
            c, l, p, genome, g_base, read_packed, max_clusters=max_clusters,
            window=window, max_out=max_out,
        ),
        max_out=max_out, max_rows=max_rows,
    )


def _rev_ops_bound(max_ops: int, max_out: int) -> int:
    """Static width of the shifted cigar: stage B's compress width and the
    width of the reverse step's forward leg.  A left-shifted cigar has at
    most (input runs + 1) runs (tests/test_shift_run_bound.py), so only
    bucket-edge reads can exceed ``max_ops``; they take the exact host
    path through the compress overflow flag."""
    return min(max_out, max_ops)


def rev_batch(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
              ref_win, ref_base, read_seq, *, max_out, max_clusters, window,
              max_rows=None) -> dict:
    """The reverse step over one batch of table slots of reverse-contig
    items: left-shift the indels against the reversed contig
    (read_alignment_scanner.rs:159-176), then the forward step.

    The JAX package compiles this one function in three layouts:
    ``rev_batch`` (stage A, stage B and ``fwd_batch`` as separate device
    calls), ``rev_chain_batch`` (the whole chain as one program, mm form)
    and ``rev_batch_fused`` (one program per item, vmapped).  PyTorch runs
    eagerly, so the port has the one function; its outputs equal
    ``rev_batch(mm=False)`` and ``rev_batch_fused`` field for field, and
    ``rev_chain_batch`` on the items neither side flags.

    ``contig_win`` (B, max_seq) uint8 is the reversed contig from
    ``win_base`` (B,) int32 on; ``pos`` is absolute on the reversed contig.
    Returns the dict of ``fwd_batch``."""
    rel_pos = pos - win_base
    st = shift_stage_a(ops, lens, rel_pos, win_base, contig_win, read_seq,
                       max_clusters=max_clusters, window=window)
    n = ops.shape[1]
    sh_codes, sh_lens, sh_n, sh_pos, sh_fb = shift_stage_b(
        ops, lens, rel_pos, st, window=window,
        max_out=_rev_ops_bound(n, max_out),
    )
    sh_fb = sh_fb | (sh_n > n)
    out = fwd_batch(
        sh_codes[:, :n], sh_lens[:, :n], sh_n,
        sh_pos + win_base, bk, bv, nb, ref_win, ref_base, read_seq,
        max_out=max_out, max_clusters=max_clusters, window=window,
        max_rows=max_rows,
    )
    out["fallback"] = out["fallback"] | sh_fb
    return out


def bucket_kwargs(bcfg: BucketConfig) -> dict:
    """fwd_batch's static keyword arguments for one bucket."""
    return dict(
        max_out=bcfg.resolved_max_out(),
        max_clusters=bcfg.max_clusters,
        window=bcfg.window,
        max_rows=bcfg.resolved_max_rows(),
    )


# The fewest rows a Python-feed group runs at.
MIN_GROUP_ROWS = 64


def group_rows(b: int) -> int:
    """The rows a Python-feed group of ``b`` items runs at: the smallest
    power of two that is at least ``max(b, 64)``.  A group's size changes
    with nearly every flush; padded to these few rungs, a run compiles one
    step per (kind, bucket, rung) it meets."""
    return 1 << (max(b, MIN_GROUP_ROWS) - 1).bit_length()


def group_inputs(is_rev: bool, bcfg: BucketConfig, devs, rows: int
                 ) -> tuple[np.ndarray, ...]:
    """The step inputs of one Python-feed group at ``rows`` rows, in
    ``rev_batch``'s positional order with ``is_rev``, else ``fwd_batch``'s.
    Row i holds ``devs[i]``, one item's prepared inputs (``_Item.dev``); the
    rows past ``len(devs)`` are empty, as the unused rows of a native slot
    are: PAD ops, zero lengths and counts, INT32_MAX keys, -1 values and
    zero windows."""
    if len(devs) > rows:
        raise ValueError(f"{len(devs)} items do not fit {rows} rows")
    ops = np.full((rows, bcfg.max_ops), PAD, np.int32)
    lens = np.zeros((rows, bcfg.max_ops), np.int32)
    n_ops = np.zeros(rows, np.int32)
    pos = np.zeros(rows, np.int32)
    bk = np.full((rows, bcfg.max_blocks), INT32_MAX, np.int32)
    bv = np.full((rows, bcfg.max_blocks), -1, np.int32)
    nb = np.zeros(rows, np.int32)
    ref_win = np.zeros((rows, bcfg.max_seq), np.uint8)
    ref_base = np.zeros(rows, np.int32)
    read_seq = np.zeros((rows, bcfg.max_seq), np.uint8)
    if is_rev:
        contig_win = np.zeros((rows, bcfg.max_seq), np.uint8)
        win_base = np.zeros(rows, np.int32)
    for i, d in enumerate(devs):
        n = len(d["cigar"])
        ops[i, :n] = d["cigar"][:, 0]
        lens[i, :n] = d["cigar"][:, 1]
        n_ops[i] = n
        pos[i] = d["pos"]
        k = len(d["keys"])
        bk[i, :k] = d["keys"]
        bv[i, :k] = d["vals"]
        nb[i] = k
        ref_win[i] = d["ref_win"]
        ref_base[i] = d["ref_base"]
        read_seq[i, : len(d["read_seq"])] = d["read_seq"]
        if is_rev:
            contig_win[i] = d["contig_win"]
            win_base[i] = d["win_base"]
    if is_rev:
        return (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
                ref_win, ref_base, read_seq)
    return (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq)


def group_step(cache, device, is_rev: bool, bcfg: BucketConfig, arrays,
               b: int) -> dict:
    """One Python-feed group through its compiled step: ``rev_batch`` with
    ``is_rev``, else ``fwd_batch`` (table slots), over ``arrays``
    (``group_inputs``) on ``device``.  The step is captured in ``cache`` (a
    ``models.compiled.StepCache``) once per kind, bucket and row count, and
    each group is one replay (on the CPU, the eager step on the same static
    inputs).  Waits for the group and returns rows ``[:b]`` of every output
    field as numpy arrays of their own."""
    # mesh imports models.compiled, which imports this module
    from portello_tpu_torch.parallel.mesh import sharded_step

    step = sharded_step(cache, "rev" if is_rev else "fwd",
                        [torch.device(device)], len(arrays[0]),
                        bucket_kwargs(bcfg))
    out = step.submit(*arrays).wait()
    return {k: v[:b].copy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The Python feed's batch engine.  The host-side prep below is a copy of the
# JAX package's (``_count_update_rows``, ``_Item``, ``DeviceEngine``): that
# module imports jax at its top, so the port cannot import it.


def _count_update_rows(cigar: np.ndarray, pos: int, keys: np.ndarray) -> int:
    """Host-side liftover update-grid row count, matching the device formula
    (liftover_parallel: per ref-consuming op ``hi - lo + 1`` block visits over
    the windowed keys, 1 per read-only I/S/H op).  Used to bucket items under
    a ``max_rows``-reduced grid; the kernel's row_overflow flag backstops it."""
    if len(cigar) == 0:
        return 0
    codes = cigar[:, 0]
    rc = cg.CONSUMES_REF[codes].astype(bool)
    ro = (codes == cg.I) | (codes == cg.S) | (codes == cg.H)
    rl = np.where(rc, cigar[:, 1], 0)
    s = pos + np.cumsum(rl) - rl
    e = s + rl
    lo_raw = np.searchsorted(keys, s, side="right")
    hi = np.minimum(np.searchsorted(keys, e, side="left"), len(keys))
    pre = lo_raw == 0
    lo = np.clip(lo_raw - 1, 0, hi)
    return int(np.where(rc, hi - lo + pre, np.where(ro, 1, 0)).sum())


@dataclass
class _Item:
    """One (read segment x contig segment) liftover work item."""

    read_key: int
    seg_index: int          # index into the read's ordered splits
    contig_segment_index: int
    need_flip: bool
    is_rev_contig: bool
    host_fallback: bool = False
    skip_unmapped: bool = False
    # device inputs (None when host_fallback/skip)
    dev: dict | None = None
    bucket: int = -1
    # result (filled by flush)
    result: object = None


class DeviceEngine:
    """Batching executor for phase-2 liftover work, on one torch device.

    ``submit(record, emit)`` queues a primary read; batches run when
    ``batch_size`` items accumulate; ``flush(emit)`` drains.  Each flush
    runs one step per (bucket, orientation) group: ``fwd_batch``, or
    ``rev_batch`` for reverse-contig items under device-shift routing
    (``host_shift=False`` or ``PTPU_HOST_SHIFT=0``).  A group of B items is
    padded with empty rows to ``group_rows(B)`` and runs as one replay of
    the step compiled for its kind, bucket and row count (``group_step``);
    the engine's ``StepCache`` holds those steps and is freed with it.
    Items that exceed every bucket, or that the step flags, are finished on
    the exact host path.  ``stats`` counts items, batches, the groups by
    ``kind/bucket/rows``, the compiled steps (``compiled_steps``,
    ``replays``, ``t_capture``, as the native feed names them) and the
    kernel launches of this engine's steps."""

    def __init__(
        self,
        reference,
        contig_list,
        all_contig_mapping_info,
        device: torch.device,
        batch_size: int = 512,
        buckets=DEFAULT_BUCKETS,
        is_target_region: bool = False,
        host_shift: bool | None = None,
    ):
        self.reference = reference
        self.contig_list = contig_list
        self.info = all_contig_mapping_info
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.is_target_region = is_target_region
        # Rev-item routing: True (default) runs the reverse-contig indel
        # left-shift (reference read_alignment_scanner.rs:159-176) on the
        # host during prep, so rev items dispatch the forward step;
        # PTPU_HOST_SHIFT=0 (or host_shift=False) runs rev_batch instead.
        # Exactly "0", as the JAX DeviceEngine reads it; the native feed
        # reads the switch as its C++ scanner does (host_shift_routing).
        self.host_shift = (
            host_shift
            if host_shift is not None
            else os.environ.get("PTPU_HOST_SHIFT", "1") != "0"
        )
        # models.compiled imports this module
        from portello_tpu_torch.models.compiled import StepCache

        self._cache = StepCache()
        self.stats = {
            "device_items": 0, "host_items": 0, "fallback_items": 0,
            "batches": 0, "rev_batches": 0, "groups": {},
            **self._cache.stats(),
            "kernel_launches": dict.fromkeys(_cuda.launch_counts, 0),
        }
        self._pending: list[tuple] = []  # (record, ordered_splits, [_Item])
        self._n_items = 0

    # -- work item preparation (host side) --------------------------------
    def _pick_bucket(
        self, n_ops: int, n_blocks: int, seq_len: int, ref_span: int, n_rows: int
    ):
        for bi, b in enumerate(self.buckets):
            if (
                n_ops <= b.max_ops
                and n_blocks <= b.max_blocks
                and seq_len <= b.max_seq
                and ref_span <= b.max_seq
                and n_rows <= b.resolved_max_rows()
            ):
                return bi
        return -1

    def _prep_item(self, record, read_segment, ci, seg_info, rev_contig_seq, read_key, seg_index):
        seg = seg_info.seq_order_segment
        contig_is_fwd = seg.is_fwd_strand
        changes_strand = record.is_reverse() == read_segment.is_fwd_strand
        need_flip = (not contig_is_fwd) ^ changes_strand
        item = _Item(
            read_key=read_key,
            seg_index=seg_index,
            contig_segment_index=ci,
            need_flip=need_flip,
            is_rev_contig=not contig_is_fwd,
        )

        bm = seg_info.contig_to_ref_map
        if contig_is_fwd:
            pos = read_segment.pos
            cigar = read_segment.cigar
        else:
            contig_length = self.contig_list.data[read_segment.chrom_index].length
            seg_end = read_segment.pos + cg.get_cigar_ref_offset(read_segment.cigar)
            pos = contig_length - seg_end
            cigar = cg.reverse_cigar(read_segment.cigar)
            if self.host_shift:
                # Host-shift routing (default): run the exact oracle shift
                # here and dispatch the item through the forward step.
                from portello_tpu_torch.ops.shift import left_shift_indels

                read_seq = rev_comp(record.seq) if need_flip else record.seq
                pos, cigar = left_shift_indels(
                    pos, cigar, rev_contig_seq, read_seq
                )
                item.is_rev_contig = False  # forward-step routing

        if (cigar[:, 0] == cg.P).any():
            # Pad ops: the reference's compress keeps only the first length
            # of an adjacent-Pad run (ops/cigar.py quirk note) while the
            # device compress sums; aligners never emit P, so the rare
            # padded cigar goes to the exact host path.
            item.host_fallback = True
            return item
        if item.is_rev_contig and (cigar[:, 1] == 0).any():
            # Zero-length ops on the device-shift rev path: a 0-length I/D
            # forms a phantom cluster in the device left shift (find_clusters
            # is not length-gated) whose homology cap clamps the pending
            # run, where the oracle ignores 0-length indels (ops/shift.py).
            # Legal-but-degenerate BAM; the exact host path takes it.
            item.host_fallback = True
            return item

        span = cg.get_cigar_ref_offset(cigar)
        lo, hi = bm.range_indices(pos, pos + span)
        keys = np.asarray(bm.keys[lo:hi])
        vals = np.asarray(bm.vals[lo:hi])
        valid = vals != NONE
        if not valid.any():
            # No mapped block overlaps the read span: liftover would only ever
            # see gap blocks -> guaranteed unmapped.  Skip the device.
            item.skip_unmapped = True
            return item

        # ref2 window covering every position the lifted alignment can touch
        nxt = np.concatenate([keys[1:], [pos + span]])
        ref_lo = int(vals[valid].min())
        ref_hi = int((vals + np.minimum(nxt, pos + span) - keys)[valid].max())
        ref_span = ref_hi - ref_lo

        bucket = self._pick_bucket(
            len(cigar), hi - lo, record.seq_len(), ref_span,
            _count_update_rows(cigar, pos, keys),
        )
        if bucket < 0:
            item.host_fallback = True
            return item
        bcfg = self.buckets[bucket]

        read_seq = rev_comp(record.seq) if need_flip else record.seq
        chrom_index = seg.chrom_index
        ref_win = np.zeros(bcfg.max_seq, dtype=np.uint8)
        win = self.reference[chrom_index][ref_lo:ref_hi]
        ref_win[: len(win)] = win

        dev = {
            "cigar": cigar, "pos": pos, "keys": keys, "vals": vals,
            "ref_win": ref_win, "ref_base": ref_lo, "read_seq": read_seq,
        }
        if item.is_rev_contig:
            # the reversed contig's window for the device left shift
            cwin = np.zeros(bcfg.max_seq, dtype=np.uint8)
            src = rev_contig_seq[pos : pos + span]
            if span > bcfg.max_seq:
                item.host_fallback = True
                return item
            cwin[: len(src)] = src
            dev["contig_win"] = cwin
            dev["win_base"] = pos
        item.dev = dev
        item.bucket = bucket
        return item

    # -- public API --------------------------------------------------------
    def submit(self, record, emit) -> None:
        ordered_splits = get_seq_order_read_split_segments(self.contig_list, record)
        items = []
        for seg_index, read_segment in enumerate(ordered_splits):
            contig_info = self.info[read_segment.chrom_index]
            contig_segments = contig_info.ordered_contig_segment_info
            for ci in get_contig_split_segments_from_read_mapping(
                read_segment, contig_segments
            ):
                items.append(
                    self._prep_item(
                        record, read_segment, ci, contig_segments[ci],
                        contig_info.rev_contig_seq, len(self._pending), seg_index,
                    )
                )
        self._pending.append((record, ordered_splits, items))
        self._n_items += sum(1 for it in items if it.dev is not None)
        if self._n_items >= self.batch_size:
            self.flush(emit)

    def flush(self, emit) -> None:
        if not self._pending:
            return
        self._run_batches()
        for record, ordered_splits, items in self._pending:
            remapped = []
            for item in items:
                rec = self._finish_item(record, ordered_splits, item)
                if rec is not None:
                    remapped.append(rec)
            emit(
                finish_remapped_alignment_set(
                    self._ref_chrom_list_cache(), record, remapped,
                    self.is_target_region,
                )
            )
        self._pending.clear()
        self._n_items = 0

    _ref_chrom_list = None

    def set_ref_chrom_list(self, ref_chrom_list):
        self._ref_chrom_list = ref_chrom_list

    def _ref_chrom_list_cache(self):
        if self._ref_chrom_list is None:
            raise RuntimeError("DeviceEngine.set_ref_chrom_list() not called")
        return self._ref_chrom_list

    # -- batch execution ---------------------------------------------------
    def _run_batches(self) -> None:
        by_group: dict[tuple[int, bool], list[_Item]] = {}
        for _, _, items in self._pending:
            for item in items:
                if item.dev is not None:
                    by_group.setdefault((item.bucket, item.is_rev_contig), []).append(item)
        for (bucket, is_rev), items in by_group.items():
            self._run_group(bucket, is_rev, items)

    def _run_group(self, bucket: int, is_rev: bool, items: list[_Item]) -> None:
        bcfg = self.buckets[bucket]
        b = len(items)
        rows = group_rows(b)
        launches_before = dict(_cuda.launch_counts)
        out = group_step(self._cache, self.device, is_rev, bcfg,
                         group_inputs(is_rev, bcfg, [it.dev for it in items],
                                      rows), b)
        self.stats["batches"] += 1
        self.stats["rev_batches"] += is_rev
        shape = f"{'rev' if is_rev else 'fwd'}/{bucket}/{rows}"
        self.stats["groups"][shape] = self.stats["groups"].get(shape, 0) + 1
        self.stats.update(self._cache.stats())
        for k, v in _cuda.launch_counts.items():
            self.stats["kernel_launches"][k] += v - launches_before[k]
        self.stats["device_items"] += b
        for i, item in enumerate(items):
            if out["fallback"][i]:
                item.host_fallback = True
                item.dev = None
                self.stats["fallback_items"] += 1
            elif not out["mapped"][i]:
                item.skip_unmapped = True
                item.dev = None
            else:
                n = int(out["n_out"][i])
                cigar = np.empty((n, 2), dtype=np.int64)
                cigar[:, 0] = out["codes"][i, :n]
                cigar[:, 1] = out["lens"][i, :n]
                item.result = (
                    int(out["ref2_pos"][i]), cigar, int(out["read_len"][i])
                )
                item.dev = None

    def _finish_item(self, record, ordered_splits, item: _Item):
        read_segment = ordered_splits[item.seg_index]
        contig_info = self.info[read_segment.chrom_index]
        seg_info = contig_info.ordered_contig_segment_info[item.contig_segment_index]
        if item.skip_unmapped:
            return None
        if item.host_fallback:
            self.stats["host_items"] += 1
            return get_liftover_alignment_for_read_and_contig_segment(
                self.reference,
                self.contig_list,
                record,
                read_segment,
                item.contig_segment_index,
                seg_info,
                contig_info.rev_contig_seq,
            )
        ref2_pos, cigar, lifted_read_len = item.result
        # Read-length invariant (read_alignment_scanner.rs:204-229).
        if lifted_read_len != record.seq_len():
            raise AssertionError(
                f"Failed to remap qname: {record.qname.decode()}: seq len "
                f"{record.seq_len()} != lifted cigar read len {lifted_read_len}"
            )
        return finish_lifted_record(
            record,
            self.contig_list,
            read_segment,
            item.contig_segment_index,
            seg_info,
            seg_info.seq_order_segment.chrom_index,
            ref2_pos,
            cigar,
            item.need_flip,
        )
