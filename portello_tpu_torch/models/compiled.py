"""Compiled device steps: the port's counterpart of ``jax.jit``.

The JAX package jits ``fwd_batch``, ``fwd_batch_resident`` and
``rev_batch`` with static shape arguments, so each slot shape compiles once
and each batch is one asynchronous enqueue.  Here each such step is
captured once as a CUDA graph over static input tensors of the slot's
shapes and dtypes (``FWD_FIELDS``, ``RESIDENT_FIELDS``, ``REV_FIELDS``),
and each batch is one ``replay()``: a forward batch's 380-389 kernels and a
reverse batch's 586 go to the card in one launch.

``StepCache`` keys its graphs as ``jax.jit`` keys its executables: the step
kind (``fwd`` on table slots, ``fwd_resident`` or ``rev``), the static
keyword arguments of ``bucket_kwargs``, the shapes of the inputs (B among
them), the device and the shard's position in its mesh.  A resident step
reads the genome at the address it was captured with, so the key holds the
genome's address and size too: another genome gets a graph of its own,
never a stale one.

On a CUDA device the first call for a key runs the eager step
``WARMUP_CALLS`` times on the graph's own stream (which also builds the
kernel library outside any capture), then captures it once.  A failed
capture raises; nothing falls back to the eager step.  The kernel
wrappers count a launch when they launch (``kernels/_cuda.check``), which
under a graph is at capture: warm-up and capture launches are kept out of
``_cuda.launch_counts``, each graph keeps the counts it captured, and every
replay adds them.  On a CPU device the compiled step is the eager step,
run on the same static inputs, so the staging around it
(``parallel/mesh.ShardedStep``) runs and is tested on the CPU too.
"""

from __future__ import annotations

import contextlib
import gc
import time
from functools import partial

import torch

from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.models.pipeline_model import (
    FWD_FIELDS,
    RESIDENT_FIELDS,
    REV_FIELDS,
    fwd_batch,
    fwd_batch_resident,
    rev_batch,
)

# The step kinds: the eager step and its positional inputs (a resident
# step's genome follows them).
KINDS = {
    "fwd": (fwd_batch, FWD_FIELDS),
    "fwd_resident": (fwd_batch_resident, RESIDENT_FIELDS),
    "rev": (rev_batch, REV_FIELDS),
}
WARMUP_CALLS = 3


@contextlib.contextmanager
def uncounted():
    """Keep the kernel launches made inside the block out of
    ``_cuda.launch_counts``; yields a dict that holds them on exit."""
    before = dict(_cuda.launch_counts)
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        for k, v in _cuda.launch_counts.items():
            made[k] = v - before.get(k, 0)
        _cuda.launch_counts.clear()
        _cuda.launch_counts.update(before)


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` with the stream it is warmed up on,
    captured on and replayed on."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()

    @contextlib.contextmanager
    def capture(self):
        """Capture the block on the graph's stream.  ``torch.cuda.graph``
        would first run a full garbage collection and empty the allocator's
        cache, which in a CLI process holding a run's contig tables costs
        more than the capture; the collector is paused during the capture
        instead, so that no collection frees tensors inside it.  The
        capture is thread-local: the BGZF writers' codec threads copy and
        launch on their own streams while a call captures
        (``kernels/bgzf_deflate.py``), which a global capture forbids."""
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.synchronize(self.stream.device)
            with torch.cuda.stream(self.stream):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    yield
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


def _genome_key(genome) -> tuple | None:
    if genome is None:
        return None
    return (genome.data_ptr(), genome.numel(), str(genome.device))


class Captured:
    """``step(*inputs[, genome])`` captured once over static copies of
    ``inputs`` on ``device`` (theirs by default), or, with no graph (a CPU
    device), run eagerly on them.

    ``graph`` is ``CudaGraph`` by default on CUDA; the tests pass a stub
    with the same ``capture()``/``replay()`` to check the launch
    bookkeeping on the CPU."""

    def __init__(self, step, inputs, genome=None, graph=None, device=None):
        self.step = step
        self.genome = genome
        self.device = torch.device(device or inputs[0].device)
        self.inputs = tuple(t.to(self.device, copy=True) for t in inputs)
        if graph is None and self.device.type == "cuda":
            graph = CudaGraph(self.device)
        self.graph = graph
        self.stream = getattr(graph, "stream", None)
        self.launches = dict.fromkeys(_cuda.launch_counts, 0)
        self.replays = 0
        self.outputs = None
        self.capture_seconds = 0.0
        self.capture_ns = None  # (t0, t1) on time.monotonic_ns
        if graph is None:
            return
        t0 = time.monotonic_ns()
        with self._device(), uncounted():
            if self.stream is not None:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with self.on_stream():
                for _ in range(WARMUP_CALLS):
                    self._run()
            if self.stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(self.stream)
        with self._device(), uncounted() as self.launches:
            with graph.capture():
                self.outputs = self._run()
        self.capture_ns = (t0, time.monotonic_ns())
        self.capture_seconds = (self.capture_ns[1] - t0) / 1e9

    def _run(self) -> dict:
        extra = () if self.genome is None else (self.genome,)
        return self.step(*self.inputs, *extra)

    def _device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def on_stream(self):
        """The graph's stream as the current stream (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def launch(self, inputs=None) -> dict:
        """Copy ``inputs`` (if given) into the static inputs and run the
        step once: one replay, whose captured launches are added to
        ``_cuda.launch_counts``.  The caller holds ``on_stream()``; the
        copies are asynchronous from pinned host memory, and the returned
        static outputs are overwritten by the next launch.  On the CPU the
        step runs eagerly and returns fresh outputs."""
        if inputs is not None:
            if len(inputs) != len(self.inputs):
                raise ValueError(f"expected {len(self.inputs)} inputs, got "
                                 f"{len(inputs)}")
            for dst, src in zip(self.inputs, inputs):
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"input {tuple(src.shape)} {src.dtype} does not fit "
                        f"the captured {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src, non_blocking=True)
        self.replays += 1
        if self.graph is None:
            return self._run()
        self.graph.replay()
        for k, v in self.launches.items():
            _cuda.launch_counts[k] = _cuda.launch_counts.get(k, 0) + v
        return self.outputs

    def replay(self) -> dict:
        """One launch on the static inputs as they stand, ordered after the
        work queued on the caller's current stream and before the work the
        caller queues next, as an eager call would be."""
        if self.stream is None:
            return self.launch()
        with self._device():
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with self.on_stream():
                out = self.launch()
            current.wait_stream(self.stream)
        return out


def step_function(kind: str, kw: dict):
    """The eager step of ``kind`` with its static keyword arguments bound."""
    if kind not in KINDS:
        raise ValueError(f"unknown step kind {kind!r}; one of {sorted(KINDS)}")
    return partial(KINDS[kind][0], **kw)


def capture(kind: str, kw: dict, inputs, genome=None, device=None
            ) -> Captured:
    """The step ``kind`` with keyword arguments ``kw`` captured over static
    copies of ``inputs`` (its positional tensors) on ``device`` (theirs by
    default); the resident step's ``genome`` is read in place."""
    step = step_function(kind, kw)
    fields = KINDS[kind][1]
    if len(inputs) != len(fields):
        raise ValueError(f"{kind} takes {len(fields)} inputs, got {len(inputs)}")
    if (genome is None) != (kind != "fwd_resident"):
        raise ValueError(f"{kind}: a genome goes with the resident step only")
    for t, (name, dtype) in zip(inputs, fields):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    return Captured(step, inputs, genome, device=device)


def kw_key(kw: dict) -> tuple:
    """Static keyword arguments as part of a cache key."""
    return tuple(sorted(kw.items()))


class StepCache:
    """The compiled steps of one run, keyed as ``jax.jit`` keys its
    executables.  ``clear`` frees its graphs, their memory pools and the
    staging buffers and genome replicas of the sharded steps it holds at
    once; a dropped cache frees them at Python's next cyclic collection,
    since each sharded step refers back to it."""

    def __init__(self):
        self._entries: dict = {}

    def clear(self) -> None:
        self._entries.clear()

    def graphs(self) -> list[Captured]:
        return [e for e in self._entries.values() if isinstance(e, Captured)]

    def stats(self) -> dict:
        """The feeds' stats of these steps: ``compiled_steps`` (graphs
        captured), ``replays`` and ``t_capture`` (seconds of warm-up and
        capture)."""
        graphs = self.graphs()
        return {"compiled_steps": len(graphs),
                "replays": sum(g.replays for g in graphs),
                "t_capture": sum(g.capture_seconds for g in graphs)}

    def graph(self, kind: str, kw: dict, inputs, device, shard: int = 0,
              genome=None) -> Captured:
        """The step for ``kind``, ``kw``, the inputs' shapes, ``device``,
        the shard's position and the genome; on a miss it is captured over
        ``inputs``, which then serve as its first data."""
        key = ("graph", kind, kw_key(kw),
               tuple((tuple(t.shape), t.dtype) for t in inputs),
               str(torch.device(device)), shard, _genome_key(genome))
        return self.memo(key, lambda: capture(kind, kw, inputs, genome,
                                              device))

    def memo(self, key: tuple, make):
        """The entry under ``key``, made by ``make()`` on a miss."""
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = make()
        return entry


def compiled_steps_line(stats: dict, mesh, n_batches: int) -> str:
    """The feeds' log line of their compiled steps (``StepCache.stats``)
    over ``n_batches`` batches on ``mesh``."""
    how = "CUDA graphs" if torch.device(mesh[0]).type == "cuda" else "eager"
    return (f"Compiled steps: {stats['compiled_steps']} ({how} on "
            f"{', '.join(sorted({str(d) for d in mesh}))}), {stats['replays']} "
            f"replays for {n_batches} batches over {len(mesh)} shards; warm-up "
            f"and capture {stats['t_capture']:.3f} s")
