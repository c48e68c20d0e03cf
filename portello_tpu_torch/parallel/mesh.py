"""Data-parallel dispatch of the device steps over the local GPUs.

Port of ``portello_tpu.parallel.mesh``.  Each read lifts on its own, so the
natural layout is a 1-D ``data`` mesh: every batch tensor splits on dim 0
into one contiguous block of rows per device, each device runs the whole
single-device step on its block, and the outputs join in mesh order.  No
step needs a collective.  The resident genome is the one input that every
shard reads whole, so each device holds a replica of it.

A mesh here is an ordered list of ``torch.device``; a device may appear in
it more than once (two shards on one card, or several on the CPU, as the
tests and ``chip_smoke.py`` run it).  A sharded step issues every shard
before it gathers any, from this one host thread; on CUDA each shard runs
under ``torch.cuda.device`` of its own device, so its kernels go to that
device's current stream.

``PTPU_SHARD=1`` makes the native feed dispatch through the mesh
(``sharding_mesh``).  Unlike the JAX package, the port does not shard by
itself on a multi-device host: one host thread issues every shard's
launches, and the steps are launch-bound, so n GPUs fed from one thread
run a batch slower than one GPU does.
"""

from __future__ import annotations

import contextlib
import logging
import os
from functools import partial

import numpy as np
import torch

from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models.pipeline_model import (
    fwd_batch,
    fwd_batch_resident,
    rev_batch,
)

logger = logging.getLogger("portello-tpu")


def local_devices(device) -> list[torch.device]:
    """The devices a run on ``device`` can shard over: every visible CUDA
    device (``CUDA_VISIBLE_DEVICES`` applies) for a CUDA ``device``, and
    ``[device]`` itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The first ``n_devices`` (all, when None) of ``devices``, or of the
    visible CUDA devices when ``devices`` is None.  ``devices`` may repeat a
    device.  Raises ValueError when fewer devices are there than asked for;
    it never falls back to the CPU."""
    if devices is None:
        devices = local_devices("cuda")
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices}, "
                f"{len(devs)} available"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def shard_batch(mesh, arrays) -> list[tuple[torch.Tensor, ...]]:
    """Split each (B, ...) array (numpy or tensor) on dim 0 into one
    contiguous block of B / n rows per mesh device, and copy block i to
    device i.  Returns one tuple of tensors per device, in mesh order.

    A block of a CPU array on a CPU device, or of a tensor already on its
    device, is a view, not a copy.  Raises ValueError when n does not
    divide B."""
    n = len(mesh)
    tensors = [a if isinstance(a, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    b = tensors[0].shape[0]
    for t in tensors:
        if t.shape[0] != b:
            raise ValueError(f"batch sizes differ: {t.shape[0]} and {b}")
    if b % n:
        raise ValueError(f"batch size {b} is not divisible by the {n} mesh "
                         "devices")
    rows = b // n
    return [tuple(t[i * rows:(i + 1) * rows].to(dev) for t in tensors)
            for i, dev in enumerate(mesh)]


def replicate(mesh, words) -> list[torch.Tensor]:
    """The resident genome (``build_global_ref``'s words, or a flat uint8
    array) as the flat genome on each mesh device, in mesh order: one copy
    per distinct device, which every shard on that device shares."""
    copies: dict = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = genome_tensor(words, dev)
    return [copies[dev] for dev in mesh]


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run_sharded(mesh, step, shards, per_shard=None) -> dict:
    """``step(*shard, *per_shard[i])`` on each mesh device, every shard
    issued before any is gathered; each output field's shards joined in
    mesh order on the mesh's first device.  A one-device mesh returns the
    step's own dict."""
    outs = []
    for i, (dev, shard) in enumerate(zip(mesh, shards)):
        extra = () if per_shard is None else (per_shard[i],)
        with _on(dev):
            outs.append(step(*shard, *extra))
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k].to(mesh[0]) for o in outs]) for k in outs[0]}


def _sharded(mesh, step, kw):
    """``step`` with keyword arguments ``kw`` over batches split on
    ``mesh``."""

    def run(*arrays):
        return _run_sharded(mesh, partial(step, **kw), shard_batch(mesh, arrays))

    return run


def make_sharded_fwd_step(mesh, **kw):
    """The forward step over table slots, sharded over ``mesh``: a callable
    over ``fwd_batch``'s ten positional inputs, each (B, ...) with B
    divisible by the mesh size, that returns ``fwd_batch``'s dict with the
    same fields, shapes and dtypes, on the mesh's first device.  ``kw`` are
    ``fwd_batch``'s keyword arguments (``bucket_kwargs``)."""
    return _sharded(mesh, fwd_batch, kw)


def make_sharded_fwd_resident_step(mesh, **kw):
    """The forward step over resident slots, sharded over ``mesh``: a
    callable over ``fwd_batch_resident``'s eleven batch inputs and, in place
    of the genome, its replicas from ``replicate(mesh, words)``; each shard
    reads the replica on its own device.  Returns ``fwd_batch_resident``'s
    dict on the mesh's first device."""

    def run(*arrays):
        *batch, genomes = arrays
        if len(genomes) != len(mesh):
            raise ValueError(f"{len(genomes)} genome replicas for a mesh of "
                             f"{len(mesh)}")
        return _run_sharded(mesh, partial(fwd_batch_resident, **kw),
                            shard_batch(mesh, batch), genomes)

    return run


def make_sharded_rev_step(mesh, **kw):
    """The reverse step, sharded over ``mesh``: a callable over
    ``rev_batch``'s twelve positional inputs that returns its dict on the
    mesh's first device.

    The port's ``rev_batch`` is one eager function whose outputs equal the
    JAX package's ``rev_batch(mm=False)`` and ``rev_batch_fused`` field for
    field, so this one step stands for both of the JAX package's
    ``make_sharded_rev_step`` (gather form) and
    ``make_sharded_rev_step_fused``.  There is no ``mm`` argument: the
    one-hot matmul form is TPU layout and is not ported."""
    return _sharded(mesh, rev_batch, kw)


def sharding_mesh(device, batch_size: int):
    """The mesh the native feed shards its batches over, or None when it
    dispatches on ``device`` alone.

    ``PTPU_SHARD`` reads as in the JAX package's native feed (``1`` on,
    ``0`` off, any other value unset), but unset means off: ``1`` shards
    over ``local_devices(device)`` (on the CPU, a one-device mesh), and
    exits (``SystemExit``, with the JAX package's message) when the device
    count does not divide the batch size.  The JAX package shards by itself
    on a multi-device host; here a CUDA run with several visible GPUs logs
    that it uses one."""
    devs = local_devices(device)
    n = len(devs)
    force = {"1": True, "0": False}.get(os.environ.get("PTPU_SHARD", ""))
    if not force:
        if force is None and torch.device(device).type == "cuda" and n > 1:
            logger.info(f"{n} local GPUs visible; batches run on {device} "
                        "(PTPU_SHARD=1 shards them over all)")
        return None
    if batch_size % n != 0:
        raise SystemExit(
            f"PTPU_SHARD=1 requires --batch-size divisible by the "
            f"{n} local devices (got {batch_size})"
        )
    return make_mesh(devices=devs)
