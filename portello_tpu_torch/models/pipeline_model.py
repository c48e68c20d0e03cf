"""The forward step: liftover -> cleanup+compress -> indel simplify.

Port of ``portello_tpu.models.pipeline_model`` (``_lift_core``, ``_fwd_item``,
``fwd_batch`` with ``mm=False`` and ``fwd_batch_resident``) as batched
PyTorch functions.  Under host-shift routing every batch of the native feed,
forward or reverse contig, runs one forward step: ``fwd_batch_resident`` in
resident slot mode (the default), ``fwd_batch`` on table slots.  A step runs
on whatever device its input tensors live on: on CUDA, cleanup+compress and
the window runs are the hand-written kernels; on the CPU, their plain
PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from portello_tpu_torch.kernels.cigar_kernels import (
    cigar_read_len,
    cleanup_and_compress,
)
from portello_tpu_torch.kernels.liftover_parallel import liftover_batch
from portello_tpu_torch.kernels.resident import global_base
from portello_tpu_torch.kernels.simplify_kernel import (
    simplify_batch,
    simplify_batch_resident,
)
from portello_tpu_torch.models.batch import BucketConfig

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


def bucket_kwargs(bcfg: BucketConfig) -> dict:
    """fwd_batch's static keyword arguments for one bucket."""
    return dict(
        max_out=bcfg.resolved_max_out(),
        max_clusters=bcfg.max_clusters,
        window=bcfg.window,
        max_rows=bcfg.resolved_max_rows(),
    )
