"""Entry points of the port for a program that compiles or checks it: the
production forward step with an example batch (``entry``), and a dry run
of every sharded production
step against its single-device result (``dryrun_multichip``).

Counterpart of the JAX package's root ``__graft_entry__.py``, on the same
example batches: its own copy of ``_resident_args_from_table``, its
``make_item_arrays`` and its resident helpers, so nothing of the JAX package
is imported.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from portello_tpu_torch.kernels.resident import (
    _ENC_LUT,
    SEQ_SYMBOLS,
    build_global_ref,
    genome_tensor,
    pack_seq_rows,
    split_global_base,
)
from portello_tpu_torch.models.batch import BucketConfig
from portello_tpu_torch.models.pipeline_model import (
    batch_from_numpy,
    fwd_batch,
    fwd_batch_resident,
    resident_batch_from_numpy,
    rev_batch,
    rev_batch_from_numpy,
)
from portello_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_fwd_resident_step,
    make_sharded_fwd_step,
    make_sharded_rev_step,
    replicate,
)
from portello_tpu_torch.testutil.batchgen import make_item_arrays


def _resident_args_from_table(fwd_items):
    """Map table-form fwd args to paired resident-form args whose outputs
    are bit-identical: each item's ref window row becomes its own "chrom" in
    the global superblock table, and read rows re-encode through the BAM
    16-symbol alphabet (applied to BOTH forms so the window compares see the
    same bytes)."""
    (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq) = [
        np.asarray(a) for a in fwd_items
    ]
    alpha = np.frombuffer(SEQ_SYMBOLS, np.uint8)
    read_seq = np.where(
        read_seq == 0, np.uint8(0), alpha[_ENC_LUT[read_seq]]
    ).astype(np.uint8)
    words, goff = build_global_ref(list(ref_win))
    g_sb, g_off = split_global_base(goff)
    table_args = (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base,
                  read_seq)
    res_args = (ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
                pack_seq_rows(read_seq))
    return table_args, res_args, words


def entry(device=None):
    """Return ``(fn, args)``: the production forward step
    (``fwd_batch_resident``: the genome resident on the device, packed read
    rows) with its static arguments bound, and the example batch of the JAX
    package's ``entry()`` (8 items at read length 1500) as tensors on
    ``device``, CUDA by default."""
    device = torch.device("cuda" if device is None else device)
    bcfg = BucketConfig(
        max_ops=128, max_blocks=32, max_seq=2048, max_clusters=48, window=32
    )
    rng = np.random.default_rng(0)
    items = make_item_arrays(rng, 8, bcfg, read_len=1500)
    _, res_args, words = _resident_args_from_table(items)

    fn = partial(
        fwd_batch_resident,
        max_out=bcfg.resolved_max_out(),
        max_clusters=bcfg.max_clusters,
        window=bcfg.window,
    )
    return fn, (*resident_batch_from_numpy(res_args, device),
                genome_tensor(words, device))


def require_equal(got: dict, want: dict, what: str) -> None:
    """Every field of ``want`` in ``got`` with the same shape, dtype and
    values; raises AssertionError naming the first that differs."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: fields {sorted(got)} != {sorted(want)}")
    for k, w in want.items():
        g = got[k].to(w.device)
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what} diverges on '{k}'")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Build a mesh of ``n_devices`` (the first visible GPUs when
    ``devices`` is None; ``devices`` may repeat one), run each sharded
    production step once on a small batch of B = 4 * n_devices, and hold it
    to the single-device step on the mesh's first device, field for field:
    the forward step on table slots, the resident step (genome replicated)
    against the table step on the paired inputs, the unsharded resident
    step against the same, and the reverse step."""
    mesh = make_mesh(n_devices, devices)
    dev = mesh[0]
    bcfg = BucketConfig(
        max_ops=64, max_blocks=16, max_seq=512, max_clusters=24, window=16
    )
    b = n_devices * 4
    rng = np.random.default_rng(1)
    kw = dict(
        max_out=bcfg.resolved_max_out(),
        max_clusters=bcfg.max_clusters,
        window=bcfg.window,
        # the reduced update-grid graph (overflow -> fallback flag, the
        # same on both paths)
        max_rows=112,
    )

    fwd_items = make_item_arrays(rng, b, bcfg, read_len=300)
    out = make_sharded_fwd_step(mesh, **kw)(*fwd_items)
    single_fwd = fwd_batch(*batch_from_numpy(fwd_items, dev), **kw)
    require_equal(out, single_fwd, "sharded fwd step")

    table_args, res_args, words = _resident_args_from_table(fwd_items)
    res_out = make_sharded_fwd_resident_step(mesh, **kw)(
        *res_args, replicate(mesh, words)
    )
    single_res = fwd_batch(*batch_from_numpy(table_args, dev), **kw)
    require_equal(res_out, single_res, "sharded resident fwd step")
    plain_res = fwd_batch_resident(
        *resident_batch_from_numpy(res_args, dev), genome_tensor(words, dev),
        **kw,
    )
    require_equal(plain_res, single_res, "resident fwd step")

    rev_items = make_item_arrays(rng, b, bcfg, read_len=300, rev=True)
    rout = make_sharded_rev_step(mesh, **kw)(*rev_items)
    single_rev = rev_batch(*rev_batch_from_numpy(rev_items, dev), **kw)
    require_equal(rout, single_rev, "sharded rev step")
