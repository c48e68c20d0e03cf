"""Data-parallel dispatch of the device steps over the local GPUs.

Port of ``portello_tpu.parallel.mesh``.  Each read lifts on its own, so the
natural layout is a 1-D ``data`` mesh: every batch tensor splits on dim 0
into one contiguous block of rows per device, each device runs the whole
single-device step on its block, and the outputs join in mesh order.  No
step needs a collective.  The resident genome is the one input that every
shard reads whole, so each device holds a replica of it.

A mesh here is an ordered list of ``torch.device``; a device may appear in
it more than once (two shards on one card, or several on the CPU, as the
tests and ``chip_smoke.py`` run it).  A sharded step (``ShardedStep``) runs
one compiled step (``models/compiled.py``: one CUDA graph) per mesh
position over its block of rows, each on its own stream: it stages the
batch in pinned host buffers, issues every shard's copies and replay before
it waits on any, and copies each shard's outputs straight into its rows of
pinned host output buffers.  The native feed dispatches every batch this
way, its mesh ``device`` alone unless ``PTPU_SHARD=1``.

``PTPU_SHARD=1`` makes the native feed dispatch through the mesh of every
local device (``sharding_mesh``).  Unlike the JAX package, the port does
not shard by itself on a multi-device host: the step is latency-bound (a
quarter batch takes about the device time of a whole one), so a batch
split over four GPUs runs no faster than on one.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models.compiled import KINDS, StepCache, kw_key

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


# Batches a sharded step holds in flight: each owns one set of staging
# buffers for its inputs and one for its outputs.
IN_FLIGHT = 2


class Handle:
    """A dispatched batch: ``wait()`` blocks until its outputs are on the
    host and returns them as numpy arrays, views of the step's output
    staging that the batch two dispatches later on the same step
    overwrites."""

    def __init__(self, outputs: dict, events: list):
        self.outputs = outputs
        self.events = events
        self.done = False

    def wait(self) -> dict:
        for e in self.events:
            e.synchronize()
        self.done = True
        return {k: v.numpy() for k, v in self.outputs.items()}


class _Staging:
    """One in-flight batch's host buffers: pinned on CUDA, plain on the
    CPU."""

    def __init__(self, shapes, fields, pin: bool):
        self.pin = pin
        self.inputs = tuple(
            torch.empty(shape, dtype=dtype, pin_memory=pin)
            for shape, (_, dtype) in zip(shapes, fields))
        self.outputs: dict = {}
        self.handle: Handle | None = None

    def output(self, name: str, like: torch.Tensor, b: int) -> torch.Tensor:
        if name not in self.outputs:
            self.outputs[name] = torch.empty(
                (b, *like.shape[1:]), dtype=like.dtype, pin_memory=self.pin)
        return self.outputs[name]


class ShardedStep:
    """One step kind over ``mesh`` at one batch size: one compiled step
    (``models/compiled.py``) per mesh position over its contiguous block of
    B / n rows, fed through ``IN_FLIGHT`` sets of staging buffers.

    ``submit(*arrays)`` copies a batch's (B, ...) arrays (numpy, or CPU
    tensors) into its staging buffers, which frees the caller's arrays at
    once; then, on each shard's own stream, copies the shard's rows to the
    static inputs, replays the step, copies each output field into the
    shard's rows of the host output buffers and records an event.  Every
    shard is issued before any is waited on; ``submit`` returns a
    ``Handle`` without waiting.  One stream per shard orders each shard's
    copies, replay and output copies, so a static output is copied out
    before its step replays again; a staging set is rewritten only after
    the batch that used it has been waited on, its events passed."""

    def __init__(self, cache, kind: str, mesh, kw: dict, genomes=None):
        self.cache, self.kind, self.kw = cache, kind, kw
        self.mesh = [torch.device(d) for d in mesh]
        self.fields = KINDS[kind][1]
        if (genomes is None) != (kind != "fwd_resident"):
            raise ValueError(f"{kind}: genome replicas go with the resident "
                             "step only")
        if genomes is not None and len(genomes) != len(self.mesh):
            raise ValueError(f"{len(genomes)} genome replicas for a mesh of "
                             f"{len(self.mesh)}")
        self.genomes = genomes
        self.pin = any(d.type == "cuda" for d in self.mesh)
        self.shapes = None
        self._staging: list[_Staging | None] = [None] * IN_FLIGHT
        self._next = 0

    def submit(self, *arrays) -> Handle:
        if len(arrays) != len(self.fields):
            raise ValueError(f"{self.kind} takes {len(self.fields)} arrays, "
                             f"got {len(arrays)}")
        if self.shapes is None:  # the first batch fixes the slot's shapes
            self.shapes = tuple(tuple(a.shape) for a in arrays)
        i = self._next
        st = self._staging[i]
        if st is None:
            st = self._staging[i] = _Staging(self.shapes, self.fields, self.pin)
        elif st.handle is not None and not st.handle.done:
            raise RuntimeError(f"more than {IN_FLIGHT} batches in flight on "
                               "one step")
        for dst, a, (name, dtype) in zip(st.inputs, arrays, self.fields):
            # numpy's one-thread copy: a torch copy of this size would wake
            # the OpenMP pool, whose spinning workers then take the cores
            # of the native feed's scanner threads
            src = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            out = dst.numpy()
            if src.dtype != out.dtype or src.shape != out.shape:
                raise ValueError(f"{name}: {src.shape} {src.dtype}, the step "
                                 f"takes {tuple(dst.shape)} {dtype}")
            np.copyto(out, src)
        self._next = (i + 1) % IN_FLIGHT
        b = st.inputs[0].shape[0]
        shards = shard_batch([torch.device("cpu")] * len(self.mesh), st.inputs)
        rows = b // len(self.mesh)
        events = []
        for j, (dev, shard) in enumerate(zip(self.mesh, shards)):
            genome = None if self.genomes is None else self.genomes[j]
            step = self.cache.graph(self.kind, self.kw, shard, dev, j, genome)
            with _on(dev), step.on_stream():
                out = step.launch(shard)
                for name, t in out.items():
                    dst = st.output(name, t, b)[j * rows:(j + 1) * rows]
                    dst.copy_(t, non_blocking=True)
                if step.stream is not None:
                    # a blocking event: the waiting thread sleeps and leaves
                    # its core to the scanner threads
                    events.append(torch.cuda.Event(blocking=True))
                    events[-1].record(step.stream)
        st.handle = Handle(st.outputs, events)
        return st.handle

    def __call__(self, *arrays) -> dict:
        """``submit``, then wait: the output fields as host tensors of their
        own."""
        handle = self.submit(*arrays)
        handle.wait()
        return {k: v.clone() for k, v in handle.outputs.items()}


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def sharded_step(cache, kind: str, mesh, b: int, kw: dict, genomes=None
                 ) -> ShardedStep:
    """The ``ShardedStep`` of ``kind`` over ``mesh`` at batch size ``b`` in
    ``cache`` (a ``models.compiled.StepCache``), made on first use."""
    key = ("sharded", kind, tuple(str(d) for d in mesh), b, kw_key(kw),
           None if genomes is None else tuple(g.data_ptr() for g in genomes))
    return cache.memo(key, lambda: ShardedStep(cache, kind, mesh, kw, genomes))


def _sharded(mesh, kind, kw):
    """``kind`` with keyword arguments ``kw`` over batches split on
    ``mesh``: a callable over the step's positional inputs (and, for the
    resident step, the genome replicas last) that returns its output fields
    as host tensors.  Its compiled steps live as long as it does."""
    cache = StepCache()

    def run(*arrays):
        genomes = None
        if kind == "fwd_resident":
            *arrays, genomes = arrays
        return sharded_step(cache, kind, mesh, len(arrays[0]), kw,
                            genomes)(*arrays)

    return run


def make_sharded_fwd_step(mesh, **kw):
    """The forward step over table slots, sharded over ``mesh``: a callable
    over ``fwd_batch``'s ten positional inputs, each (B, ...) with B
    divisible by the mesh size, that returns ``fwd_batch``'s dict with the
    same fields, shapes and dtypes, on the host.  ``kw`` are
    ``fwd_batch``'s keyword arguments (``bucket_kwargs``)."""
    return _sharded(mesh, "fwd", kw)


def make_sharded_fwd_resident_step(mesh, **kw):
    """The forward step over resident slots, sharded over ``mesh``: a
    callable over ``fwd_batch_resident``'s eleven batch inputs and, in place
    of the genome, its replicas from ``replicate(mesh, words)``; each shard
    reads the replica on its own device.  Returns ``fwd_batch_resident``'s
    dict on the host."""
    return _sharded(mesh, "fwd_resident", kw)


def make_sharded_rev_step(mesh, **kw):
    """The reverse step, sharded over ``mesh``: a callable over
    ``rev_batch``'s twelve positional inputs that returns its dict on the
    host.

    The port's ``rev_batch`` is one eager function whose outputs equal the
    JAX package's ``rev_batch(mm=False)`` and ``rev_batch_fused`` field for
    field, so this one step stands for both of the JAX package's
    ``make_sharded_rev_step`` (gather form) and
    ``make_sharded_rev_step_fused``.  There is no ``mm`` argument: the
    one-hot matmul form is TPU layout and is not ported."""
    return _sharded(mesh, "rev", kw)


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
