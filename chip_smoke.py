#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``portello_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  -- requires a CUDA device; prints its name and nvidia-smi's
   name and power limit.
2. build   -- builds the CUDA kernels (nvcc, sm_90a, one process per
   source) and the native scanner.
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the device steps' shapes, with equality required (tolerance 0: all data
   is integers); median CUDA-event times of both.  Kernel 1 runs at both
   sites of every bucket (K = 352 / 464, 704 / 912 and 2816 / 3600), and
   on the reverse step's stage-B emission streams (K=257, 513 and 2049, odd
   widths with zero-length non-PAD ops), kernel 2 on stage A's homology
   runs (backward, contig windows, limits up to the read length), on the
   edges of its contract (rows not a multiple of 16 bytes, windows of 64
   and 100) and on the very calls the table step and the reverse step make
   on phase 4's batch, recorded by a wrapper patched over its own.  The
   window-runs kernel runs both of its contracts, the resident one on a
   synthetic 3.1 Gbp genome on the card (offsets past 2^31, windows at the
   genome's end).
4. steps   -- at B=512 HiFi items (18 kb, primary bucket): the forward step
   in both slot modes (the table step on CUDA against the CPU; the resident
   step, items placed in a 3.1 GB genome, on CUDA against the table step
   and against the resident step on the CPU) and the reverse step
   ``rev_batch`` on CUDA against the CPU, at window base 0 and with half the
   items at nonzero window bases; every output field equal; ms/batch of
   each step, device busy share, H2D bytes, fallback count, kernel launches
   per path.  Then the three sharded steps (``parallel/mesh.py``) on a mesh
   of every visible GPU, or of two shards on the one card: the genome
   replicated once per distinct device (its allocation logged), every
   output field equal to the single-device step's, each kernel launched n
   times per batch, ms/batch and device time beside the single-device
   step's; and ``graft_entry``: ``entry()`` on the card equal to
   ``entry(device="cpu")``, ``dryrun_multichip`` on the same mesh.
   Each step compiled (``models/compiled.py``, one CUDA graph per step and
   shard, fed by ``parallel/mesh.ShardedStep`` through pinned staging), on
   one device and on two shards of the card: two batches in flight, each
   equal to the eager step on every field; launches per replay equal to
   the captured counts and to the eager step's; ms per call of the replay
   and of the eager step, device ms, a lone call from host arrays through
   the staging beside an eager one, and the hand kernels inside a replay.
   The sharded steps above are these compiled steps.  Then the Python
   feed's compiled group steps (``check_group_steps``): groups of 37, 300
   and 517 of the batch's items, forward and reverse, padded to 64, 512
   and 1024 rows and replayed, rows ``[:b]`` equal to the eager step at b
   rows on the card and on the CPU, launches per replay the eager step's.
4b. spill  -- the spill path's steps at B=512: ~20 kb items at 129-256 ops
   in the mid bucket and 25-60 kb items in the wide bucket
   (``testutil/spill.spill_jobs``).  Per bucket
   the table, resident (items placed in a 3.1 GB genome) and reverse steps
   (window base 0 and moved bases) on the card: every unflagged item equal
   to the exact C++ core (``ops/native_core.py``), the resident step equal
   to the table step, the first 64 rows equal to the CPU plain steps; H2D
   bytes per batch against the slot shapes (``SPILL_H2D``), ms/batch, device
   time and kernels, each hand kernel's ms per call inside the step,
   launches, fallbacks and peak memory; and the compiled steps as in phase
   4.  Then the hostile-rate fuzz of the small bucket on the card (seeds
   0-3 and the cluster-overflow item).
5. e2e     -- the CLI (``python -m portello_tpu_torch.main --device cuda``)
   on the 18 kb bench scenario: the native feed in resident slot mode (the
   default), on table slots (``PTPU_RESIDENT=0``), under device-shift
   routing (``PTPU_HOST_SHIFT=0``, reverse batches on table slots), and
   with ``PTPU_SHARD=1`` in resident slot mode and under device-shift
   routing (sharded over every GPU; on a one-GPU machine a one-shard
   mesh); the Python feed under host-shift and under device-shift routing.
   The sorted
   SAM records of each must equal the exact host path's, run both as
   ``python -m portello_tpu.main --device host`` (the JAX package's CLI in a
   subprocess; nothing of it is imported here) and as ``python -m
   portello_tpu_torch.main --device host``; wall seconds, reads/s, item counts,
   H2D bytes per batch, reverse batches, kernel launches per path.  Then
   the scale-out and profiling flags, on the native feed in resident slot
   mode: ``--local-workers 2`` (two forked workers sharing the card),
   two concurrent ``--num-hosts 2 --host-id h --coordinator`` processes
   (gloo rendezvous) whose shards ``merge_bams`` joins, and ``--profile``,
   whose Chrome trace must name kernels 1 and 3.  Each run's merged records
   must equal the host path's, and each worker's and host's log must show
   launches of kernels 1 and 3.  Every process of either feed must log that
   it ran its steps as CUDA graphs, one replay per batch and shard; the
   Python feed's, at most one graph per (kind, bucket, rows) it met.
5b. spill e2e -- ``--device cuda`` on the WGS-shaped scenario
   (``testutil/spill.build_scenario``: 2-60 kb reads) on the native feed in
   resident and table slots and under device-shift routing, and on the
   Python feed (each with batches in all three buckets and host items), on
   the fallback reads of ``testutil/spill.build_inputs`` under both
   routings (a flagged item under device shift), and on the 18 kb scenario
   with CRAM 3.1 input, ``--target-region`` on BAM and on CRAM 3.1; each
   run's records equal to the port's ``--device host`` (a CRAM run's with
   ``=``/``X`` written as ``M``), its H2D bytes those of its buckets' slots.

6. bench  -- ``python -m portello_tpu_torch.bench`` with its defaults in
   a subprocess (B=512 18 kb items, the 10,000-read e2e leg); its JSON line
   printed on a line of its own, the resident graph, launches of kernels 1
   and 3 on the timed legs (compiled and eager, the same per call) and of
   kernel 2 on the table and chain diagnostics, finite positive times and
   rates, the native C++ baseline and the e2e fields required.

Phases 4b, 5, 5b and 6's inputs (the spill items, both scenarios and the
bench's e2e scenario in its cache) build in
spawned worker processes during phase 2 and phase 4's batch, before anything
is timed (``start_inputs``); the ``--device host`` references run one at a
time in phases 5 and 5b, each wall logged alone.
Imports nothing of JAX.  The last line of stdout is the JSON device record.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816
GENOME_BYTES = 3_100_000_000  # GRCh38-sized resident genome (64-aligned)
W = 48                        # the buckets' simplify window

KERNELS = ("cleanup_and_compress", "match_run", "window_match")

# The order in which phases 4 and 4b time the eager and the sharded steps,
# one pass each (the compiled steps are timed in ``check_graphs``).
STEP_ORDER = ("table", "resident", "rev")

# The least time for a kernel's work: the bytes it must move (each input read
# once, each output written once) over the H100 SXM's HBM3 rate at its full
# 700 W (NVIDIA's data sheet).  The three kernels do a few integer operations
# per byte, far below the card's rate, so bytes bound them all.
HBM_BYTES_PER_S = 3.35e12

# The device kernel of each wrapper, as torch.profiler names it.
KERNEL_FUNCTIONS = {
    "cleanup_and_compress": "cleanup_and_compress_kernel",
    "match_run": "match_run_kernel",
    "window_match": "window_runs_resident_kernel",
}

# The kernels each path must launch, read from the launch counts of one run;
# it must launch no other.
PATH_KERNELS = {
    "resident": ("cleanup_and_compress", "window_match"),
    "table": ("cleanup_and_compress", "match_run"),
    "rev": ("cleanup_and_compress", "match_run"),
    "native_devshift": ("cleanup_and_compress", "match_run"),
    # the native feed's sharded dispatch (PTPU_SHARD=1)
    "shard_resident": ("cleanup_and_compress", "window_match"),
    "shard_devshift": ("cleanup_and_compress", "match_run"),
    "python": ("cleanup_and_compress", "match_run"),
    "python_devshift": ("cleanup_and_compress", "match_run"),
    # phase 5's scale-out runs, each process on resident slots
    "workers": ("cleanup_and_compress", "window_match"),
    "hosts": ("cleanup_and_compress", "window_match"),
    "profile": ("cleanup_and_compress", "window_match"),
    # phase 4b's steps in the mid and wide buckets
    "spill_table": ("cleanup_and_compress", "match_run"),
    "spill_resident": ("cleanup_and_compress", "window_match"),
    "spill_rev": ("cleanup_and_compress", "match_run"),
    # phase 5b's runs: the WGS-shaped scenario on both feeds, slot modes and
    # routings, the fallback reads, CRAM and --target-region inputs
    "wgs_resident": ("cleanup_and_compress", "window_match"),
    "wgs_table": ("cleanup_and_compress", "match_run"),
    "wgs_devshift": ("cleanup_and_compress", "match_run"),
    "wgs_python": ("cleanup_and_compress", "match_run"),
    "fallback": ("cleanup_and_compress", "window_match"),
    "fallback_devshift": ("cleanup_and_compress", "match_run"),
    "cram": ("cleanup_and_compress", "window_match"),
    "region_bam": ("cleanup_and_compress", "window_match"),
    "region_cram": ("cleanup_and_compress", "window_match"),
}

# Phase 4b's buckets by index in DEFAULT_BUCKETS, and the H2D bytes of one
# B=512 slot of each kind in each bucket: what the slot shapes give, and
# what the native feed's log must show (phase 5b).
SPILL_BUCKETS = {1: "mid", 2: "wide"}
SPILL_H2D = {
    0: {"table": 25_894_912, "resident": 7_024_640, "rev": 38_479_872},
    1: {"table": 26_615_808, "resident": 7_745_536, "rev": 39_200_768},
    2: {"table": 72_884_224, "resident": 22_556_672, "rev": 106_440_704},
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_ms(fn, reps: int = 20) -> tuple[float, str, float]:
    """Milliseconds per call of ``fn``: the device time of the kernels it
    launches, from ``torch.profiler`` over ``reps`` calls.  The profiler now
    and then records no device activity at all; after three such tries, the
    CUDA-event time per call over a loop of ``reps`` calls instead (host
    launch overhead included).  The third value is the device activities
    (kernels and copies) per call, 0 where the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return (sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps,
                    "device", len(dev) / reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events", 0.0


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def compress_bytes(b: int, k: int, max_out: int) -> int:
    """Kernel 1: codes and lens in, codes and lens out, n_out, shift and
    overflow."""
    return b * k * 8 + b * max_out * 8 + b * 9


def window_resident_bytes(b: int, c: int, n_mixed: int, w: int) -> int:
    """Kernel 3, resident: the mask and both outputs of every pair, each
    item's genome base, and per mixed pair its four arguments, two genome
    windows of W bytes and two packed read windows of W / 2 bytes."""
    return 9 * b * c + 8 * b + n_mixed * (16 + 3 * w)


def window_table_bytes(b: int, c: int, w: int) -> int:
    """Kernel 3, Pallas contract: both starts and both runs of every pair,
    and its two windows of W bytes."""
    return b * c * (16 + 2 * w)


def match_run_bytes(limit, run, w: int) -> int:
    """Kernel 2: both starts, the limit and the run of every pair, and the
    bytes each side compares: the run and the mismatch that ends it, within
    the limit clamped to the window."""
    lim = limit.clamp(0, w).long()
    compared = int((run.long() + 1).minimum(lim).sum())
    return 16 * limit.numel() + 2 * compared


def require_launches(launches: dict, path: str, where: str) -> None:
    """The kernels of ``path`` launched at least once, the others never."""
    for name in KERNELS:
        if name in PATH_KERNELS[path]:
            require(launches.get(name, 0) > 0, f"{where}: no {name} launch")
        else:
            require(launches.get(name, 0) == 0,
                    f"{where}: {name} launched on the {path} path")


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired outputs, compared as int64."""
    import torch

    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"output shape/dtype differ: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi_line}")
    return name, smi_line


# ---------------------------------------------------------------- phase 2
def phase_build():
    """The CUDA kernels (nvcc), the native scanner and the exact C++ core
    (g++), all three builds at once."""
    from concurrent.futures import ThreadPoolExecutor

    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.ops import native_core
    from portello_tpu_torch.pipeline import native_feed

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        done = {}

        def timed(name, fn):
            fn()
            done[name] = time.perf_counter() - t0

        futures = [ex.submit(timed, "CUDA kernels", _cuda.get_lib),
                   ex.submit(timed, "ptscan", native_feed.get_lib),
                   ex.submit(timed, "ptcore", native_core.get_lib)]
        for f in futures:
            f.result()
    require(native_feed.get_lib() is not None,
            f"native scanner (ptscan) build failed: {native_feed.build_error()}")
    require(native_core.get_lib() is not None,
            f"C++ core (ptcore) build failed: {native_core.build_error()}")
    log(f"build: CUDA kernels (nvcc {' '.join(_cuda.NVCC_FLAGS[:2])}) -> "
        f"{os.path.relpath(_cuda.SO_PATH, HERE)}, the native scanner and the "
        f"C++ core built at once: ready after " + ", ".join(
            f"{name} {sec:.1f} s" for name, sec in done.items()))


# ---------------------------------------------------------------- phase 3
def compress_case(rng, b: int, k: int):
    """Random op streams with zero lengths, PAD runs and edge indels."""
    import numpy as np

    codes = rng.integers(0, 10, size=(b, k)).astype(np.int32)
    lens = rng.integers(0, 24000, size=(b, k)).astype(np.int32)
    lens[rng.random((b, k)) < 0.3] = 0
    # long runs of one code, so some rows compress below max_out
    for i in range(8, b, 3):
        codes[i] = np.repeat(rng.integers(0, 10, size=k // 8 + 1), 8)[:k]
    # PAD tails of varied length
    for i in range(4, b, 5):
        codes[i, rng.integers(0, k):] = 9
    codes[0, :] = 9                     # all PAD
    lens[1, :] = 0                      # all zero length
    codes[2, :] = 9
    codes[2, 0], lens[2, 0] = 0, 5      # one op
    codes[3, :4] = [2, 1, 0, 2]         # D I M D: edge indels on both sides
    lens[3, :4] = [3, 2, 7, 4]
    codes[3, 4:] = 9
    return codes, lens


def match_case(rng, b: int, c: int, w: int, length: int):
    """Mostly-equal rows (runs of every length) and starts over [-W, L]."""
    import numpy as np

    a = rng.integers(65, 69, size=(b, length), dtype=np.uint8)
    bb = a.copy()
    mut = rng.random((b, length)) < 0.03
    bb[mut] = rng.integers(60, 64, size=int(mut.sum()), dtype=np.uint8)
    bb[:, -64:] = 0  # in-row zero padding compares as data
    a[:, -32:] = 0
    ia = rng.integers(-w, length + 1, size=(b, c)).astype(np.int32)
    shift = np.where(rng.random((b, c)) < 0.8, 0,
                     rng.integers(-3, 4, size=(b, c)))
    ib = np.clip(ia + shift, -w, length).astype(np.int32)
    ia[:, 0], ib[:, 0] = -w, -w          # the domain's ends
    ia[:, 1], ib[:, 1] = length, length
    ia[:, 2], ib[:, 2] = 0, 0
    limit = rng.integers(-2, w + 9, size=(b, c)).astype(np.int32)
    return a, bb, ia, ib, limit


def match_run_edge_cases(dev):
    """Kernel 2 at B=512, C=96 on the edges of its contract, from a seed of
    their own: rows of 24,571 bytes (not a multiple of 16, so rows start at
    every offset from a 16-byte boundary), a window of 64 (one whole
    mismatch mask) and of 100 (a second 64-position chunk), both
    directions.  Returns (label, args) pairs, args as ``match_run_cuda``
    takes them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 2)
    cases = []
    for w, length in ((48, 24571), (64, 24576), (100, 24576)):
        a, bb, ia, ib, limit = match_case(rng, 512, 96, w, length)
        t = [torch.from_numpy(x).to(dev) for x in (a, ia, bb, ib, limit)]
        for rev in (False, True):
            cases.append((f"edge W={w} L={length}", (*t, w, rev)))
    return cases


def captured_match_runs(rev_arrays, dev):
    """Kernel 2's calls on the main path's own B=512 batch (phase 4's):
    the table step's two (the right edges of the clusters, then the left
    edges, whose limit depends on the first call's runs) and the reverse
    step's stage A, recorded with their inputs by a wrapper patched over
    ``cluster_utils.match_run_cuda``, which ``match_run`` reads at each
    call.  Returns (label, args, launches per batch) triples."""
    import torch

    from portello_tpu_torch.kernels import cluster_utils
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
        rev_batch,
        rev_batch_from_numpy,
    )

    kw = bucket_kwargs(DEFAULT_BUCKETS[0])
    table_arrays = tuple(rev_arrays[:4]) + tuple(rev_arrays[6:])
    calls = []
    real = cluster_utils.match_run_cuda

    def record(*args):
        calls.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                           for x in args))
        return real(*args)

    cluster_utils.match_run_cuda = record
    try:
        fwd_batch(*batch_from_numpy(table_arrays, dev), **kw)
        n_table = len(calls)
        rev_batch(*rev_batch_from_numpy(rev_arrays, dev), **kw)
    finally:
        cluster_utils.match_run_cuda = real
    require(n_table == 2 and len(calls) == 5,
            f"kernel 2 calls: {n_table} in the table step, "
            f"{len(calls) - n_table} in the reverse step (want 2 and 3)")
    return [("table step, right edges", calls[0], "2 per table batch"),
            ("table step, left edges", calls[1], "2 per table batch"),
            ("reverse step, stage A", calls[2], "1 per reverse batch")]


def check_match_run(label, args):
    """Kernel 2 on ``args`` against its plain version (equality required)
    and timed; returns (max abs err, ms, plain ms, bytes)."""
    import torch

    from portello_tpu_torch.kernels.cluster_utils import (
        match_run_cuda,
        match_run_plain,
    )

    seq_a, _, seq_b, _, limit, w, rev = args
    got = match_run_cuda(*args)
    want = match_run_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    what = (f"match_run {label} B={limit.shape[0]} C={limit.shape[1]} W={w} "
            f"L={seq_a.shape[1]}/{seq_b.shape[1]} "
            f"{'backward' if rev else 'forward'}")
    require(err == 0, f"{what}: kernel != plain (max abs err {err})")
    ms, pms, times = _timed(lambda: match_run_cuda(*args),
                            lambda: match_run_plain(*args))
    nbytes = match_run_bytes(limit, got, w)
    live = limit > 0
    log(f"kernel {what}: equal; {int(live.sum())} pairs with limit > 0 "
        f"({int((limit > w).sum())} above the window), mean run "
        f"{float(got[live].float().mean()) if bool(live.any()) else 0.0:.2f}"
        f" where live; {times}; {_bound_text(nbytes, ms)}")
    return err, ms, pms, nbytes


def match_run_dense_cases(rng, dev):
    """Kernel 2 on the dense synthetic inputs of ``match_case`` at W=48,
    (C, L) = (96, 24,576) and (512, 65,536), both directions: every pair
    has a limit in [-2, W + 8]."""
    import torch

    cases = []
    for c, length in ((96, 24576), (512, 65536)):
        a, bb, ia, ib, limit = match_case(rng, 512, c, W, length)
        t = [torch.from_numpy(x).to(dev) for x in (a, ia, bb, ib, limit)]
        for rev in (False, True):
            cases.append((f"dense C={c}", (*t, W, rev)))
    return cases


def _timed(kernel, plain):
    """(kernel ms, plain ms, log text): device time per call, and the
    CUDA-event time of one call with its host overhead."""
    ms, how, _ = call_ms(kernel)
    pms, phow, _ = call_ms(plain)
    return ms, pms, (
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms ({how}/{phow} time per "
        f"call); one call with host overhead (CUDA events): kernel "
        f"{cuda_ms(kernel):.4f} ms, plain {cuda_ms(plain):.4f} ms"
    )


def _bound_text(nbytes: int, ms: float) -> str:
    return (f"bound {nbytes} bytes = {bound_ms(nbytes) * 1e3:.3f} us at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, kernel at "
            f"{bound_ms(nbytes) / ms:.1%} of it")


def phase_kernels(rng, rev_arrays):
    import numpy as np
    import torch

    from portello_tpu_torch.kernels.cigar_kernels import (
        cleanup_and_compress_cuda,
        cleanup_and_compress_plain,
    )

    dev = torch.device("cuda")
    results = {}
    # (K, max_out): the lift site (2U = 352) and finish site (2 * max_out =
    # 464) of the primary bucket, both sites of the widest bucket, then both
    # sites of the mid bucket (from a generator of their own, so the draws
    # of every later case stay as they were).
    err1 = 0
    mid_rng = np.random.default_rng(SEED + 60)
    for gen, k, max_out in ((rng, 352, 232), (rng, 464, 232),
                            (rng, 2816, 1800), (rng, 3600, 1800),
                            (mid_rng, 704, 456), (mid_rng, 912, 456)):
        codes, lens = compress_case(gen, 512, k)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        got = cleanup_and_compress_cuda(c, ln, max_out)
        want = cleanup_and_compress_plain(c, ln, max_out)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"cleanup_and_compress K={k}: kernel != plain "
                f"(max abs err {err})")
        err1 = max(err1, err)
        ms, pms, times = _timed(
            lambda: cleanup_and_compress_cuda(c, ln, max_out),
            lambda: cleanup_and_compress_plain(c, ln, max_out),
        )
        n_ovf = int(got[4].sum())
        nbytes = compress_bytes(512, k, max_out)
        log(f"kernel cleanup_and_compress B=512 K={k} max_out={max_out}: "
            f"equal (overflow rows {n_ovf}); {times}; "
            f"{_bound_text(nbytes, ms)}")
        if (k, max_out) == (352, 232):
            results["cleanup_and_compress"] = (ms, pms, nbytes)
    results["cleanup_and_compress_err"] = err1

    err2 = 0
    for label, args in match_run_dense_cases(rng, dev):
        err, ms, pms, nbytes = check_match_run(label, args)
        err2 = max(err2, err)
        if label == "dense C=96" and args[-1]:
            results["match_run"] = (ms, pms, nbytes)
    for label, args in match_run_edge_cases(dev):
        err2 = max(err2, check_match_run(label, args)[0])
    for label, args, per_batch in captured_match_runs(rev_arrays, dev):
        log(f"kernel match_run on the main path's inputs: {label}, "
            f"{per_batch}")
        err2 = max(err2, check_match_run(label, args)[0])
    results["match_run_err"] = err2
    shift = phase_shift_kernels(rng, rev_arrays)
    results["cleanup_and_compress_err"] = max(err1, shift.pop("compress_err"))
    results["match_run_err"] = max(err2, shift.pop("match_run_err"))
    results.update(shift)
    results.update(phase_window_match(rng))
    return results


def with_zero_length_clips(arrays):
    """A copy of a ``rev_batch`` batch in which every third item starts
    with a zero-length soft clip and every third other item ends with one.
    Stage B keeps such an op as a real code (``keep_zero``), so kernel 1
    sees zero-length non-PAD ops.  (The feeds send reverse items with a
    zero-length op to the host, so the main path does not produce them.)"""
    from portello_tpu_torch.kernels.cigar_kernels import S

    ops, lens, n_ops = (a.copy() for a in arrays[:3])
    for i in range(len(n_ops)):
        n = int(n_ops[i])
        if i % 3 == 2 or n >= ops.shape[1]:
            continue
        at = 0 if i % 3 == 0 else n
        ops[i, at + 1:n + 1] = ops[i, at:n].copy()
        lens[i, at + 1:n + 1] = lens[i, at:n].copy()
        ops[i, at], lens[i, at] = S, 0
        n_ops[i] = n + 1
    return (ops, lens, n_ops) + tuple(arrays[3:])


def shift_case(arrays, bcfg):
    """The reverse step's kernel inputs for a ``rev_batch`` batch, from the
    plain stage A on the CPU: stage B's emission stream (B, 2n+1) before its
    compress, and stage A's homology-run arguments (contig windows, suffix
    ends, limits)."""
    from portello_tpu_torch.kernels.cluster_utils import find_clusters
    from portello_tpu_torch.kernels.shift_kernel import (
        homology_run_args,
        shift_stage_a,
        shift_stage_b_emit,
    )
    from portello_tpu_torch.models.pipeline_model import rev_batch_from_numpy

    t = rev_batch_from_numpy(arrays, "cpu")
    ops, lens, wb, cwin, rseq = t[0], t[1], t[4], t[5], t[11]
    rel = t[3] - wb
    st = shift_stage_a(ops, lens, rel, wb, cwin, rseq,
                       max_clusters=bcfg.max_clusters, window=bcfg.window)
    codes, elens, _ = shift_stage_b_emit(ops, lens, st, window=bcfg.window)
    cl = find_clusters(ops, lens, rel, bcfg.max_clusters)
    end_ref, end_read, limit = homology_run_args(cl, wb)
    return (codes, elens), (cwin, end_ref.contiguous(), rseq,
                            end_read.contiguous(), limit.contiguous())


def reverse_step_cases(rng, rev_arrays, dev):
    """Kernels 1 and 2's inputs from the reverse step, on ``dev``: per
    bucket (label, stage B's emission stream (codes, lens), its max_out,
    stage A's homology-run arguments as ``match_run_cuda`` takes them
    without the window and direction, the window, the most ops of an
    item).  The primary bucket's case is the B=512 batch of phase 4; the
    widest bucket's is 64 items with half of them at nonzero window bases,
    each row repeated 8 times; the mid bucket's is 64 items of 129-256 ops
    made the same way from a generator of its own; in all, two items in
    three carry a zero-length soft clip."""
    import numpy as np

    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        _rev_ops_bound,
    )
    from portello_tpu_torch.testutil.batchgen import (
        make_item_arrays,
        shift_win_base,
    )

    t0 = time.perf_counter()
    wide = DEFAULT_BUCKETS[2]
    wide_arrays, _ = shift_win_base(make_item_arrays(
        rng, 64, wide, read_len=18000, read_error=0.03, rev=True), rng)
    mid, mid_rng = DEFAULT_BUCKETS[1], np.random.default_rng(SEED + 61)
    mid_arrays, _ = shift_win_base(make_item_arrays(
        mid_rng, 64, mid, read_len=20000, read_error=0.0095, rev=True),
        mid_rng)
    cases = []
    for label, arrays, bcfg, rep in (
        ("primary bucket", with_zero_length_clips(rev_arrays),
         DEFAULT_BUCKETS[0], 1),
        ("widest bucket", with_zero_length_clips(wide_arrays), wide, 8),
        ("mid bucket", with_zero_length_clips(mid_arrays), mid, 8),
    ):
        stream, homology = shift_case(arrays, bcfg)
        max_out = _rev_ops_bound(bcfg.max_ops, bcfg.resolved_max_out())
        cases.append((label, [x.repeat(rep, 1).to(dev) for x in stream],
                      max_out, [x.repeat(rep, 1).to(dev) for x in homology],
                      bcfg.window, int(arrays[2].max())))
    log(f"kernels on reverse-step inputs: plain stage A on the CPU for a "
        f"B=512 primary batch and 64 widest- and 64 mid-bucket items in "
        f"{time.perf_counter() - t0:.1f} s")
    return cases


def phase_shift_kernels(rng, rev_arrays):
    """Kernels 1 and 2 on the inputs the reverse step gives them
    (``reverse_step_cases``): stage B's emission streams (odd K,
    zero-length non-PAD ops, a trailing flush in a partial last 32-lane
    chunk) and stage A's homology runs (backward, on contig windows, limits
    far above the window)."""
    import torch

    from portello_tpu_torch.kernels.cigar_kernels import (
        M,
        PAD,
        cleanup_and_compress_cuda,
        cleanup_and_compress_plain,
    )

    results = {"compress_err": 0, "match_run_err": 0}
    cases = reverse_step_cases(rng, rev_arrays, torch.device("cuda"))
    for label, (codes, lens), max_out, homology, w, max_n in cases:
        b, k = codes.shape
        got = cleanup_and_compress_cuda(codes, lens, max_out)
        want = cleanup_and_compress_plain(codes, lens, max_out)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"cleanup_and_compress stage-B stream ({label}) "
                f"K={k}: kernel != plain (max abs err {err})")
        results["compress_err"] = max(results["compress_err"], err)
        n_zero = int(((codes != PAD) & (lens == 0)).sum())
        n_tail = int((codes[:, -1] == M).sum())
        ms, pms, times = _timed(
            lambda: cleanup_and_compress_cuda(codes, lens, max_out),
            lambda: cleanup_and_compress_plain(codes, lens, max_out),
        )
        log(f"kernel cleanup_and_compress stage-B stream ({label}, up to "
            f"{max_n} ops) B={b} K={k} max_out={max_out}: equal; "
            f"{n_zero} zero-length non-PAD ops, {n_tail} rows with the "
            f"trailing flush in the last op, overflow rows "
            f"{int(got[4].sum())}; {times}; "
            f"{_bound_text(compress_bytes(b, k, max_out), ms)}")
        results[f"compress_stage_b_{label.split()[0]}"] = (k, ms, pms)

        err, ms, pms, _ = check_match_run(f"stage-A homology ({label})",
                                          (*homology, w, True))
        results["match_run_err"] = max(results["match_run_err"], err)
        results[f"match_run_stage_a_{label.split()[0]}"] = (ms, pms)
    return results


def device_genome(n: int, seed: int):
    """A flat uint8 genome of n random ACGT bytes, made on the card."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    genome = torch.empty(n, dtype=torch.uint8, device="cuda")
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device="cuda")
    chunk = 1 << 28
    for s in range(0, n, chunk):
        part = genome[s:s + chunk]
        part.random_(0, 4, generator=gen)
        part.copy_(lut[part.long()])
    return genome


def resident_case(rng, genome, bases, c: int, max_seq: int):
    """Resident window-runs inputs on the card: item bases ``bases``, read
    rows copied from the genome there with 2% mutations, packed; about 5%
    of clusters mixed, plus clusters at the contract's edges (right window
    at -W, left window at the row's end, odd read offsets)."""
    import numpy as np
    import torch

    from portello_tpu_torch.kernels.resident import pack_seq_rows

    n = genome.shape[0]
    b = len(bases)
    dev = genome.device
    g_base = torch.from_numpy(bases).to(dev)
    idx = g_base[:, None] + torch.arange(max_seq, device=dev)
    rows = torch.where(idx < n, genome[idx.clamp(max=n - 1)], ord("N"))
    rows = rows.cpu().numpy()
    del idx
    mut = rng.random(rows.shape) < 0.02
    rows[mut] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(mut.sum()))
    bs = rng.integers(0, max_seq, size=(b, c)).astype(np.int32)
    shift = np.where(rng.random((b, c)) < 0.8, 0, rng.integers(-3, 4, size=(b, c)))
    rs = (bs + shift).astype(np.int32)
    dl = rng.integers(1, 60, size=(b, c)).astype(np.int32)
    il = np.where(rng.random((b, c)) < 0.5, dl,
                  rng.integers(1, 60, size=(b, c))).astype(np.int32)
    mixed = rng.random((b, c)) < 0.05
    bs[:, 0], rs[:, 0], dl[:, 0], il[:, 0] = 0, 0, 0, 0
    bs[:, 1], rs[:, 1] = max_seq, max_seq
    rs[:, 2] = bs[:, 2] | 1
    mixed[:, :3] = True
    host = (pack_seq_rows(rows), bs, rs, dl, il, mixed)
    return (genome, g_base, *(torch.from_numpy(x).to(dev) for x in host))


def phase_window_match(rng):
    """Kernel 3 in both contracts against its plain versions."""
    import numpy as np
    import torch

    from portello_tpu_torch.kernels.window_match import (
        pad_table,
        window_match_runs_cuda,
        window_match_runs_plain,
        window_runs_resident_cuda,
        window_runs_resident_plain,
    )

    dev = torch.device("cuda")
    results = {}
    err = 0
    t0 = time.perf_counter()
    genome = device_genome(GENOME_BYTES, SEED)
    torch.cuda.synchronize()
    n = genome.shape[0]
    log(f"kernel window_match: {n} byte random genome made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    big = rng.integers(2**31, n - 24576, size=512).astype(np.int64)
    big[-64:] = n - rng.integers(1, 200, size=64)
    cases = (
        ("primary bucket", 96, 24576,
         rng.integers(0, n - 24576, size=512).astype(np.int64)),
        ("widest bucket", 512, 65536,
         rng.integers(0, n - 65536, size=512).astype(np.int64)),
        ("bases past 2^31, 64 within 200 B of the genome end", 96, 24576, big),
    )
    for label, c, max_seq, bases in cases:
        args = resident_case(rng, genome, bases, c, max_seq)
        got = window_runs_resident_cuda(*args, W)
        want = window_runs_resident_plain(*args, W)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require(e == 0, f"window_match resident {label}: kernel != plain "
                f"(max abs err {e})")
        err = max(err, e)
        ms, pms, times = _timed(
            lambda: window_runs_resident_cuda(*args, W),
            lambda: window_runs_resident_plain(*args, W),
        )
        mixed = args[-1]
        n_mixed = int(mixed.sum())
        nbytes = window_resident_bytes(512, c, n_mixed, W)
        log(f"kernel window_match resident B=512 C={c} W={W} "
            f"max_seq={max_seq} ({label}; bases {int(bases.min())}.."
            f"{int(bases.max())} of {n}): equal; {n_mixed} mixed "
            f"clusters, mean raw_r {float(got[0][mixed].float().mean()):.2f}, "
            f"raw_l {float(got[1][mixed].float().mean()):.2f}; {times}; "
            f"{_bound_text(nbytes, ms)}")
        if label == "primary bucket":
            results["window_match"] = (ms, pms, nbytes)
        del args, got, want
    del genome
    torch.cuda.empty_cache()

    for c, length in ((96, 24576), (512, 65536)):
        a, bb, ia, ib, _ = match_case(rng, 512, c, W, length)
        ta = pad_table(torch.from_numpy(a).to(dev), 0xFE)
        tb = pad_table(torch.from_numpy(bb).to(dev), 0xFD)
        tia, tib = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
        got = window_match_runs_cuda(ta, tb, tia, tib, W)
        want = window_match_runs_plain(ta, tb, tia, tib, W)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require(e == 0, f"window_match Pallas contract C={c} L={length}: "
                f"kernel != plain (max abs err {e})")
        err = max(err, e)
        ms, pms, times = _timed(
            lambda: window_match_runs_cuda(ta, tb, tia, tib, W),
            lambda: window_match_runs_plain(ta, tb, tia, tib, W),
        )
        log(f"kernel window_match Pallas contract B=512 C={c} W={W} "
            f"L={length}: equal (mean run_fwd {float(got[0].float().mean()):.2f}"
            f", run_rev {float(got[1].float().mean()):.2f}); {times}; "
            f"{_bound_text(window_table_bytes(512, c, W), ms)}")
    results["window_match_err"] = err
    return results


# ---------------------------------------------------------------- phase 4
def _step_times(step, b: int, label: str):
    """Host-clock, CUDA-event and device times of one device step; returns
    (host-clock ms, device ms, device kernels and copies) per batch."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    samples = []
    for _ in range(25):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(samples)
    ev_ms = cuda_ms(step, reps=20)
    dev_ms, how, n_dev = call_ms(step, reps=10)
    log(f"{label}: {ms:.3f} ms/batch (median of {len(samples)}, host "
        f"clock + sync), {ev_ms:.3f} ms (CUDA events), {b / (ms / 1e3):.0f} "
        f"items/s; {how} time {dev_ms:.3f} ms/batch in {n_dev:.0f} device "
        f"kernels and copies, busy share {dev_ms / ms:.3f} of the host-clock "
        f"step")
    return ms, dev_ms, n_dev


def _kernels_in_step(step, reps: int = 10) -> dict:
    """Each hand kernel's device time per call and calls per step inside
    ``step``, from the events ``torch.profiler`` records under the kernel's
    name over ``reps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    found = {}
    for _ in range(3):  # the profiler now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        for name, function in KERNEL_FUNCTIONS.items():
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and function in e.name]
            if us:
                found[name] = (sum(us) / 1e3 / len(us), len(us) / reps)
        if found:
            break
    return found


# The step kind of each mode of phases 4 and 4b, compiled.
GRAPH_KINDS = {"table": "fwd", "resident": "fwd_resident", "rev": "rev"}
LONE_CALLS = 10


def _rolled(arrays):
    """The batch with its rows moved down by 7: other inputs in every row."""
    import numpy as np

    return tuple(np.ascontiguousarray(np.roll(a, 7, axis=0)) for a in arrays)


def _lone_ms(call) -> float:
    """Median host-clock ms of ``LONE_CALLS`` calls that each end on the
    host, after a warm-up call."""
    call()
    samples = []
    for _ in range(LONE_CALLS):
        t0 = time.perf_counter()
        call()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def check_graphs(name, kw, cases, launches, times, smi) -> dict:
    """The compiled steps (``models/compiled.py``, one CUDA graph per step
    and shard, fed by ``parallel/mesh.ShardedStep``) of one bucket at B=512.

    ``cases`` maps each mode to its numpy inputs, the genome (resident) and
    the same inputs on the card.  On one device and on two shards of the
    card: two batches, the inputs and the inputs rolled by 7 rows, are
    submitted before either is waited on, and each equals the eager step on
    the card on every field (tolerance 0); each graph's captured launches
    equal the eager step's (``launches``), and the replays count exactly
    them.  Then, on one device, the replay's ms per call (host clock +
    sync, CUDA events) and device ms beside the eager step's (``times``),
    a lone call from host arrays through the pinned staging beside an eager
    one from pageable arrays, and the hand kernels inside a replay.
    Returns the in-replay kernel times by mode."""
    import torch

    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.models.compiled import StepCache, step_function
    from portello_tpu_torch.parallel.mesh import sharded_step

    cuda = torch.device("cuda")
    b = 512
    in_step = {}
    for mode, (arrays, genome, dev_args) in cases.items():
        kind = GRAPH_KINDS[mode]
        fn = step_function(kind, kw)
        extra = () if genome is None else (genome,)
        other = _rolled(arrays)
        want = [fn(*dev_args, *extra),
                fn(*(torch.from_numpy(a).to(cuda) for a in other), *extra)]
        torch.cuda.synchronize()
        for n in (1, 2):
            mesh = [cuda] * n
            cache = StepCache()
            step = sharded_step(cache, kind, mesh, b, kw,
                                None if genome is None else [genome] * n)
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            handles = [step.submit(*arrays), step.submit(*other)]
            issue_s = time.perf_counter() - t0
            got = [h.wait() for h in handles]
            counted = dict(_cuda.launch_counts)
            for g, w, which in zip(got, want, ("first", "second")):
                require_equal({k: torch.from_numpy(v) for k, v in g.items()},
                              w, f"graphs {name} {mode} on {n} shard(s), the "
                              f"{which} of two batches in flight vs eager")
            graphs = cache.graphs()
            require(len(graphs) == n and all(g.graph for g in graphs),
                    f"graphs {name} {mode}: {len(graphs)} graphs for {n} "
                    "shards")
            for g in graphs:
                require(g.launches == launches[mode] and g.replays == 2,
                        f"graphs {name} {mode}: captured {g.launches} over "
                        f"{g.replays} replays, the eager step launches "
                        f"{launches[mode]}")
            want_counted = {k: 2 * n * v for k, v in launches[mode].items()}
            require(counted == want_counted,
                    f"graphs {name} {mode}: replays counted {counted}, want "
                    f"{want_counted}")
            log(f"graphs {name} {mode} B={b} on {n} shard(s) of one card: "
                f"two batches in flight (submitted in {issue_s:.3f} s, "
                f"capture included) == the eager step on all {len(want[0])} "
                f"fields; launches per replay {json.dumps(graphs[0].launches)}"
                f" == captured == the eager step's; counted over 2 x {n} "
                f"replays {json.dumps(counted)}")
            if n == 1:
                single, single_cache = graphs[0], cache
        ms, dev_ms, n_dev = _step_times(single.replay, b,
                                        f"graphs {name} {mode} (replay)")
        eager = times[mode]
        lone_step = sharded_step(single_cache, kind, [cuda], b, kw,
                                 None if genome is None else [genome])
        lone = _lone_ms(lambda: lone_step.submit(*arrays).wait())
        lone_eager = _lone_ms(lambda: {k: v.cpu() for k, v in fn(
            *(torch.from_numpy(a).to(cuda) for a in arrays), *extra).items()})
        in_step[mode] = _kernels_in_step(single.replay)
        log(f"graphs {name} {mode} ({smi}): ms per call (host clock + sync) "
            f"replay {ms:.3f}, eager " + " / ".join(f"{t[0]:.3f}" for t in eager)
            + f"; device ms replay {dev_ms:.3f} in {n_dev:.0f} device kernels "
            f"and copies, eager " + " / ".join(f"{t[1]:.3f}" for t in eager)
            + f"; lone call from host arrays: graph through pinned staging "
            f"{lone:.3f} ms, eager from pageable arrays {lone_eager:.3f} ms "
            f"(medians of {LONE_CALLS}); hand kernels in a replay: "
            + "; ".join(f"{kn} {kms:.4f} ms per call, {kc:.0f} calls per step"
                        for kn, (kms, kc) in in_step[mode].items()))
        for kname in PATH_KERNELS[mode]:
            require(kname in in_step[mode],
                    f"graphs {name} {mode}: a replay's profile names no {kname}")
        del single, single_cache, lone_step, want
    torch.cuda.empty_cache()
    return in_step


# The group sizes of the Python feed's compiled group steps in phase 4: a
# group padded to 64 rows, to 512 and to 1024.
GROUP_SIZES = (37, 300, 517)


def check_group_steps(rev_arrays, kw, launches, smi) -> None:
    """The Python feed's compiled group steps (``pipeline_model.group_step``
    over ``group_inputs``, as its ``DeviceEngine`` runs them) on phase 4's
    items at each of ``GROUP_SIZES``, forward (table slots) and reverse:
    each group, padded with empty rows to ``group_rows(b)``, is captured
    and replayed on the card; its rows ``[:b]`` equal the eager step at
    exactly b rows on the card and on the CPU, on every field (tolerance
    0), and its replay launches what the eager step launches
    (``launches``).  Logs the seconds the check takes."""
    import numpy as np
    import torch

    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.models.compiled import StepCache
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        fwd_batch,
        group_inputs,
        group_rows,
        group_step,
        rev_batch,
        rev_batch_from_numpy,
    )
    from portello_tpu_torch.testutil.batchgen import item_devs

    t0 = time.perf_counter()
    bcfg = DEFAULT_BUCKETS[0]
    cuda = torch.device("cuda")
    n = max(GROUP_SIZES)
    # phase 4's 512 items, then the first of them again, rolled by 7 rows
    more = tuple(np.concatenate([a, r[:n - len(a)]])
                 for a, r in zip(rev_arrays, _rolled(rev_arrays)))
    cache = StepCache()
    cpu_s = 0.0
    texts = []
    for is_rev in (False, True):
        mode = "rev" if is_rev else "table"
        step, convert = ((rev_batch, rev_batch_from_numpy) if is_rev
                         else (fwd_batch, batch_from_numpy))
        for b in GROUP_SIZES:
            arrays = tuple(a[:b] for a in more)
            if not is_rev:  # fwd_batch's inputs: without win_base, contig_win
                arrays = arrays[:4] + arrays[6:]
            padded = group_inputs(is_rev, bcfg, item_devs(arrays, is_rev),
                                  group_rows(b))
            _cuda.reset_launch_counts()  # capture and warm-up uncounted
            got = group_step(cache, cuda, is_rev, bcfg, padded, b)
            replayed = dict(_cuda.launch_counts)
            want = step(*convert(arrays, cuda), **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want_cpu = step(*convert(arrays, "cpu"), **kw)
            cpu_s += time.perf_counter() - t1
            got = {k: torch.from_numpy(v) for k, v in got.items()}
            what = f"group step {mode} b={b} ({group_rows(b)} rows)"
            require_equal(got, want, f"{what} vs the eager step on the card")
            require_equal(got, want_cpu, f"{what} vs the eager step on the CPU")
            require(replayed == launches[mode],
                    f"{what}: a replay launched {replayed}, the eager step "
                    f"{launches[mode]}")
            texts.append(f"{mode} b={b} in {group_rows(b)} rows "
                         f"({int(want_cpu['mapped'].sum())} mapped, "
                         f"{int(want_cpu['fallback'].sum())} flagged)")
    stats = cache.stats()
    graphs = cache.graphs()
    require(stats["compiled_steps"] == 2 * len(GROUP_SIZES)
            and all(g.graph for g in graphs)
            and stats["replays"] == 2 * len(GROUP_SIZES),
            f"group steps: {stats} for {2 * len(GROUP_SIZES)} groups")
    log(f"group steps (the Python feed's, padded and compiled; {smi}): "
        f"{'; '.join(texts)}: rows [:b] == the eager step at b rows on the "
        f"card and on the CPU on all {len(got)} fields; launches per replay "
        f"== the eager step's ({json.dumps(launches['table'])} table, "
        f"{json.dumps(launches['rev'])} reverse); {stats['compiled_steps']} "
        f"CUDA graphs, warm-up and capture {stats['t_capture']:.3f} s; CPU "
        f"eager steps {cpu_s:.1f} s; the check took "
        f"{time.perf_counter() - t0:.1f} s")
    del cache, graphs
    torch.cuda.empty_cache()


def hifi_batch(rng):
    """B=512 HiFi items (18 kb) in the primary bucket, as ``rev_batch``'s
    inputs; without ``win_base`` and ``contig_win`` they are ``fwd_batch``'s."""
    from portello_tpu_torch.models.pipeline_model import DEFAULT_BUCKETS
    from portello_tpu_torch.testutil.batchgen import make_item_arrays

    t0 = time.perf_counter()
    arrays = make_item_arrays(rng, 512, DEFAULT_BUCKETS[0], read_len=18000,
                              rev=True)
    log(f"built 512 HiFi items (18 kb, primary bucket) in "
        f"{time.perf_counter() - t0:.1f} s")
    return arrays


def phase_forward(rng, rev_arrays, smi):
    import torch

    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
        fwd_batch_resident,
        resident_batch_from_numpy,
        rev_batch,
        rev_batch_from_numpy,
    )
    from portello_tpu_torch.testutil.batchgen import (
        resident_from_table,
        shift_win_base,
    )

    bcfg = DEFAULT_BUCKETS[0]
    b = 512
    cuda = torch.device("cuda")
    arrays = tuple(rev_arrays[:4]) + tuple(rev_arrays[6:])
    t1 = time.perf_counter()
    g_sb, g_off, packed, genome_np = resident_from_table(
        arrays, GENOME_BYTES, rng
    )
    res_arrays = tuple(arrays[:7]) + (g_sb, g_off, arrays[8], packed)
    base = (g_sb.astype("int64") << 6) | g_off
    log(f"forward: {b} HiFi items placed in a {genome_np.shape[0]} byte "
        f"genome in {time.perf_counter() - t1:.1f} s ({int((base > 2**31).sum())}"
        f" item bases past 2^31, the last at {int(base.max())})")
    kw = bucket_kwargs(bcfg)

    # table slots
    t0 = time.perf_counter()
    want = fwd_batch(*batch_from_numpy(arrays, "cpu"), **kw)
    cpu_s = time.perf_counter() - t0
    table_args = batch_from_numpy(arrays, cuda)
    _cuda.reset_launch_counts()
    table = fwd_batch(*table_args, **kw)
    torch.cuda.synchronize()
    launches = {"table": dict(_cuda.launch_counts)}
    require_launches(launches["table"], "table", "forward table step")
    require_equal(table, want, "forward table step CUDA vs CPU")

    # resident slots: the genome goes to the card once
    t0 = time.perf_counter()
    genome = genome_tensor(genome_np, cuda)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_cpu = fwd_batch_resident(
        *resident_batch_from_numpy(res_arrays, "cpu"),
        genome_tensor(genome_np, "cpu"), **kw,
    )
    res_cpu_s = time.perf_counter() - t0
    res_args = resident_batch_from_numpy(res_arrays, cuda)
    _cuda.reset_launch_counts()
    res = fwd_batch_resident(*res_args, genome, **kw)
    torch.cuda.synchronize()
    launches["resident"] = dict(_cuda.launch_counts)
    require_launches(launches["resident"], "resident", "forward resident step")
    require_equal(res, table, "forward resident step vs table step (CUDA)")
    require_equal(res, res_cpu, "forward resident step CUDA vs CPU")

    # the reverse step, at window base 0 and with half the items at nonzero
    # window bases (each such window cut out of a longer contig)
    t0 = time.perf_counter()
    rev_cpu = rev_batch(*rev_batch_from_numpy(rev_arrays, "cpu"), **kw)
    rev_cpu_s = time.perf_counter() - t0
    rev_args = rev_batch_from_numpy(rev_arrays, cuda)
    _cuda.reset_launch_counts()
    rev = rev_batch(*rev_args, **kw)
    torch.cuda.synchronize()
    launches["rev"] = dict(_cuda.launch_counts)
    require_launches(launches["rev"], "rev", "reverse step")
    require_equal(rev, rev_cpu, "reverse step CUDA vs CPU")
    moved_arrays, moved = shift_win_base(rev_arrays, rng)
    moved_cpu = rev_batch(*rev_batch_from_numpy(moved_arrays, "cpu"), **kw)
    moved_out = rev_batch(*rev_batch_from_numpy(moved_arrays, cuda), **kw)
    torch.cuda.synchronize()
    require_equal(moved_out, moved_cpu,
                  "reverse step at nonzero window bases CUDA vs CPU")
    keep = ~rev_cpu["fallback"] & ~moved_cpu["fallback"]
    for key in rev_cpu:
        require(torch.equal(rev_cpu[key][keep], moved_cpu[key][keep]),
                f"reverse step: field {key!r} moves with the window base")
    wb = moved_arrays[4]
    log(f"reverse B={b} K_stage_b={2 * bcfg.max_ops + 1} max_out="
        f"{min(bcfg.max_ops, kw['max_out'])}: CUDA == CPU on all "
        f"{len(rev_cpu)} fields at window base 0 and with {int(moved.sum())} "
        f"items at window bases {int(wb[moved].min())}..{int(wb[moved].max())}"
        f"; those equal the base-0 batch on the {int(keep.sum())} items "
        f"neither flags; mapped {int(rev_cpu['mapped'].sum())}, fallback "
        f"{int(rev_cpu['fallback'].sum())} (base 0) and "
        f"{int(moved_cpu['fallback'].sum())} (moved); CPU plain step "
        f"{rev_cpu_s:.2f} s")

    n_fb = int(want["fallback"].sum())
    n_mapped = int(want["mapped"].sum())
    h2d = {"table": sum(t.nbytes for t in table_args),
           "resident": sum(t.nbytes for t in res_args),
           "rev": sum(t.nbytes for t in rev_args)}
    log(f"forward B={b} K_lift={2 * kw['max_rows']} max_out={kw['max_out']}: "
        f"table step CUDA == CPU, resident step CUDA == table step == "
        f"resident CPU on all {len(want)} fields; mapped {n_mapped}, fallback "
        f"{n_fb}; launches per path {json.dumps(launches)}")
    log(f"steps: genome {genome.shape[0] / 2**20:.1f} MiB uploaded in "
        f"{upload_s:.2f} s; H2D per batch: table {h2d['table']} bytes, "
        f"resident {h2d['resident']} bytes, reverse {h2d['rev']} bytes; CPU "
        f"plain steps: table {cpu_s:.2f} s, resident {res_cpu_s:.2f} s")
    steps = {
        "table": lambda: fwd_batch(*table_args, **kw),
        "resident": lambda: fwd_batch_resident(*res_args, genome, **kw),
        "rev": lambda: rev_batch(*rev_args, **kw),
    }
    labels = {"table": "forward table step", "resident": "forward resident step",
              "rev": "reverse step"}
    times = {mode: [] for mode in steps}
    for mode in STEP_ORDER:
        times[mode].append(_step_times(steps[mode], b, labels[mode]))
    log("steps: ms/batch (host clock) " + ", ".join(
        f"{mode} " + " / ".join(f"{t[0]:.3f}" for t in times[mode])
        for mode in steps))
    in_step = {}
    for mode in ("resident", "table"):
        in_step[mode] = _kernels_in_step(steps[mode])
        log(f"{labels[mode]}: hand kernels inside the step (profiler "
            f"events): " + "; ".join(
                f"{name} {ms:.4f} ms per call, {n:.0f} calls per step"
                for name, (ms, n) in in_step[mode].items()))
    for name in PATH_KERNELS["resident"]:
        require(name in in_step["resident"],
                f"the resident step's profile names no {name} kernel")
    graph_in_step = {f"primary_{mode}": t for mode, t in check_graphs(
        "primary", kw, {"table": (arrays, None, table_args),
                        "resident": (res_arrays, genome, res_args),
                        "rev": (rev_arrays, None, rev_args)},
        launches, times, smi).items()}
    check_group_steps(rev_arrays, kw, launches, smi)
    del genome
    torch.cuda.empty_cache()
    phase_sharded(genome_np, kw,
                  {"table": arrays, "resident": res_arrays, "rev": rev_arrays},
                  {"table": table, "resident": res, "rev": rev},
                  launches, smi)
    return launches, in_step, graph_in_step


def _peak_bytes(fn, devices) -> int:
    """The sum over ``devices`` of the peak bytes allocated while ``fn``
    runs once."""
    import torch

    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return sum(torch.cuda.max_memory_allocated(d) for d in devices)


def smoke_mesh():
    """Every visible GPU where there are several, else two shards on the
    one card; and a phrase that says which."""
    from portello_tpu_torch.parallel.mesh import local_devices, make_mesh

    devs = local_devices("cuda")
    if len(devs) > 1:
        return make_mesh(devices=devs), f"every visible GPU ({len(devs)})"
    return make_mesh(devices=devs * 2), "two shards on one card (cuda:0 twice)"


def phase_sharded(genome_np, kw, args, single, launches, smi):
    """The three sharded steps (``parallel/mesh.py``: one CUDA graph per
    shard, fed through pinned staging) on ``smoke_mesh()`` at phase 4's
    B=512 batch (``args``: numpy inputs by mode), the resident genome
    replicated once per distinct device: every output field equal to the
    single-device eager step's (tolerance 0), each kernel launched n times
    as often per batch, and each batch from host arrays to host outputs
    timed beside the same dispatch on a one-device mesh; then
    ``graft_entry``: ``entry()`` on the card against
    ``entry(device="cpu")``, and ``dryrun_multichip`` on the same mesh."""
    import torch

    from portello_tpu_torch import graft_entry
    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.parallel.mesh import (
        make_sharded_fwd_resident_step,
        make_sharded_fwd_step,
        make_sharded_rev_step,
        replicate,
    )

    mesh, which = smoke_mesh()
    n = len(mesh)
    distinct = sorted(set(mesh), key=str)
    log(f"sharded: a mesh of {n} shards, {which}: "
        f"{', '.join(str(d) for d in mesh)}; each shard's rows go from "
        f"pinned staging to its own device and back")
    before = {d: torch.cuda.memory_allocated(d) for d in distinct}
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    replicas = replicate(mesh, genome_np)
    for d in distinct:
        torch.cuda.synchronize(d)
    upload_s = time.perf_counter() - t0
    for d in distinct:
        added = torch.cuda.memory_allocated(d) - before[d]
        require(abs(added - genome_np.nbytes) < 2**21,
                f"sharded: replicate added {added} bytes on {d} for a "
                f"{genome_np.nbytes} byte genome")
        log(f"sharded: genome replicated, one copy on {d}: +{added} bytes "
            f"allocated ({genome_np.nbytes} byte genome), max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(d)} bytes; "
            f"{sum(1 for m in mesh if m == d)} shards share it")
    log(f"sharded: {len(distinct)} genome copies for {n} shards uploaded in "
        f"{upload_s:.2f} s")

    makers = {"table": make_sharded_fwd_step,
              "resident": make_sharded_fwd_resident_step,
              "rev": make_sharded_rev_step}

    def dispatch(m):
        """Each mode's sharded step on mesh ``m``, compiled once."""
        run = {mode: make(m, **kw) for mode, make in makers.items()}
        return {"table": lambda: run["table"](*args["table"]),
                "resident": lambda: run["resident"](*args["resident"],
                                                    replicas[:len(m)]),
                "rev": lambda: run["rev"](*args["rev"])}

    steps, one_device = dispatch(mesh), dispatch(mesh[:1])
    labels = {"table": "forward table step", "resident": "forward resident step",
              "rev": "reverse step"}
    b = args["table"][0].shape[0]
    for mode, step in steps.items():
        _cuda.reset_launch_counts()
        out = step()
        got = dict(_cuda.launch_counts)
        require_equal(out, single[mode], f"sharded {labels[mode]} vs one device")
        want = {k: n * v for k, v in launches[mode].items()}
        require(got == want, f"sharded {labels[mode]}: launches {got}, want "
                f"{n} x {launches[mode]}")
        log(f"sharded {labels[mode]} B={b} over {n} shards of {b // n}, one "
            f"graph each: equal to the single-device eager step on all "
            f"{len(out)} fields; launches per batch {json.dumps(got)} ({n} x "
            f"the single-device count, counted per replay)")
    for mode in steps:
        one_device[mode]()  # captured before its peak is read
        log(f"sharded {labels[mode]}: peak device memory over one batch "
            f"(max_memory_allocated; the genome, the graphs' static inputs "
            f"and outputs included): 1 shard "
            f"{_peak_bytes(one_device[mode], mesh[:1])} bytes, {n} shards "
            f"{_peak_bytes(steps[mode], distinct)} bytes")
    times = {mode: [] for mode in steps}
    sharded_times = {mode: [] for mode in steps}
    for mode in STEP_ORDER:
        times[mode].append(_step_times(
            one_device[mode], b, f"sharded {labels[mode]} (1 shard)"))
        sharded_times[mode].append(_step_times(
            steps[mode], b, f"sharded {labels[mode]} ({n} shards)"))
    for mode in steps:
        one, many = times[mode], sharded_times[mode]
        log(f"sharded {labels[mode]}: ms/batch from host arrays to host "
            f"outputs (host clock + sync) 1 shard "
            + " / ".join(f"{t[0]:.3f}" for t in one) + f", {n} shards "
            + " / ".join(f"{t[0]:.3f}" for t in many)
            + "; device time 1 shard "
            + " / ".join(f"{t[1]:.3f}" for t in one) + f", {n} shards "
            + " / ".join(f"{t[1]:.3f}" for t in many)
            + f" ms; device kernels and copies per batch {one[0][2]:.0f} and "
            f"{many[0][2]:.0f} ({smi})")
    del replicas, steps, one_device
    torch.cuda.empty_cache()

    fn, cuda_args = graft_entry.entry()
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    require_equal(fn(*cuda_args), cpu_fn(*cpu_args),
                  "graft_entry.entry() on the card vs on the CPU")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n, devices=mesh)
    log(f"graft_entry: entry() on the card == entry(device='cpu') on all "
        f"fields; dryrun_multichip({n}) on {which} passed (sharded fwd, "
        f"resident and rev steps == one device) in "
        f"{time.perf_counter() - t0:.2f} s")


# --------------------------------------------------------------- phase 4b
def _rows(out: dict, n: int) -> dict:
    return {k: v[:n] for k, v in out.items()}


def _native_text(counters) -> str:
    return (f"{counters['exact']} exact, {counters['fallback']} flagged, "
            f"{counters['unmapped']} unmapped")


def phase_spill_steps(smi, batches):
    """The three steps at B=512 in the mid and wide buckets on the card (on
    ``batches``: each bucket's ``rev_batch`` inputs, by bucket index),
    each unflagged item against the exact C++ core, the resident step
    against the table step, the first 64 rows against the CPU plain step;
    timed, profiled and counted; each step compiled (``check_graphs``).
    Then the hostile-rate fuzz on the card.  Returns (launches per batch,
    in-step kernel times, in-replay kernel times), by ``<bucket>_<step>``."""
    import numpy as np
    import torch

    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
        fwd_batch_resident,
        resident_batch_from_numpy,
        rev_batch,
        rev_batch_from_numpy,
    )
    from portello_tpu_torch.testutil import spill
    from portello_tpu_torch.testutil.batchgen import (
        resident_from_table,
        shift_win_base,
    )

    cuda = torch.device("cuda")
    b = 512
    rng = np.random.default_rng(SEED + 4)
    launches, in_step, graph_in_step = {}, {}, {}
    for bi, rev_arrays in batches.items():
        name = SPILL_BUCKETS[bi]
        bcfg = DEFAULT_BUCKETS[bi]
        kw = bucket_kwargs(bcfg)
        arrays = spill.fwd_of_rev(rev_arrays)
        n_ops = rev_arrays[2]
        read_len = (rev_arrays[11] != 0).sum(axis=1)
        t0 = time.perf_counter()
        g_sb, g_off, packed, genome_np = resident_from_table(
            arrays, GENOME_BYTES, rng)
        res_arrays = tuple(arrays[:7]) + (g_sb, g_off, arrays[8], packed)
        genome = genome_tensor(genome_np, cuda)
        moved_arrays, moved = shift_win_base(rev_arrays, rng)
        torch.cuda.synchronize()
        log(f"spill {name} bucket {bcfg}: {b} items, reads "
            f"{int(read_len.min())}-{int(read_len.max())} bases, "
            f"{int(n_ops.min())}-{int(n_ops.max())} ops (mean "
            f"{float(n_ops.mean()):.1f}); placed in a {genome_np.shape[0]} "
            f"byte genome on the card in {time.perf_counter() - t0:.1f} s")
        args = {
            "table": batch_from_numpy(arrays, cuda),
            "resident": resident_batch_from_numpy(res_arrays, cuda),
            "rev": rev_batch_from_numpy(rev_arrays, cuda),
        }
        steps = {
            "table": lambda: fwd_batch(*args["table"], **kw),
            "resident": lambda: fwd_batch_resident(*args["resident"], genome,
                                                   **kw),
            "rev": lambda: rev_batch(*args["rev"], **kw),
        }
        outs = {}
        for mode, step in steps.items():
            path = f"spill_{mode}"
            _cuda.reset_launch_counts()
            outs[mode] = step()
            torch.cuda.synchronize()
            launches[f"{name}_{mode}"] = dict(_cuda.launch_counts)
            require_launches(launches[f"{name}_{mode}"], path,
                             f"spill {name} {mode} step")
            h2d = sum(t.nbytes for t in args[mode])
            require(h2d == SPILL_H2D[bi][mode],
                    f"spill {name} {mode}: {h2d} H2D bytes per batch, want "
                    f"{SPILL_H2D[bi][mode]}")
        moved_out = rev_batch(*rev_batch_from_numpy(moved_arrays, cuda), **kw)
        torch.cuda.synchronize()

        # every unflagged item against the exact C++ core
        t0 = time.perf_counter()
        counts = {}
        for mode, out, args_np, rev in (
            ("table", outs["table"], arrays, False),
            ("rev", outs["rev"], rev_arrays, True),
            ("rev moved", moved_out, moved_arrays, True),
        ):
            counts[mode] = spill.new_counters()
            spill.check_native(out, args_np, kw["max_out"], counts[mode],
                               rev=rev, what=f"spill {name} {mode} step")
            require(counts[mode]["exact"] > 0,
                    f"spill {name} {mode}: no exact item ({counts[mode]})")
        native_s = time.perf_counter() - t0
        require_equal(outs["resident"], outs["table"],
                      f"spill {name} resident step vs table step (CUDA)")

        # the first 64 rows against the CPU plain step (items are independent)
        t0 = time.perf_counter()
        k = 64
        cpu_out = {
            "table": fwd_batch(*batch_from_numpy(
                tuple(a[:k] for a in arrays), "cpu"), **kw),
            "resident": fwd_batch_resident(
                *resident_batch_from_numpy(tuple(a[:k] for a in res_arrays),
                                           "cpu"),
                genome_tensor(genome_np, "cpu"), **kw),
            "rev": rev_batch(*rev_batch_from_numpy(
                tuple(a[:k] for a in rev_arrays), "cpu"), **kw),
        }
        moved_cpu = rev_batch(*rev_batch_from_numpy(
            tuple(a[:k] for a in moved_arrays), "cpu"), **kw)
        cpu_s = time.perf_counter() - t0
        for mode, want in cpu_out.items():
            require_equal(_rows(outs[mode], k), want,
                          f"spill {name} {mode} step rows 0-{k - 1} CUDA vs CPU")
        require_equal(_rows(moved_out, k), moved_cpu,
                      f"spill {name} reverse step at moved bases rows "
                      f"0-{k - 1} CUDA vs CPU")
        log(f"spill {name} B={b} K_lift={2 * kw['max_rows']} max_out="
            f"{kw['max_out']} C={kw['max_clusters']}: every unflagged item "
            f"== the C++ core (ptcore, {native_s:.1f} s): table "
            f"{_native_text(counts['table'])}; reverse at base 0 "
            f"{_native_text(counts['rev'])}; reverse with "
            f"{int(moved.sum())} items at bases up to "
            f"{int(moved_arrays[4].max())} {_native_text(counts['rev moved'])}"
            f"; resident step == table step on all {len(outs['table'])} "
            f"fields; rows 0-{k - 1} of all four == the CPU plain steps "
            f"({cpu_s:.1f} s); launches per batch {json.dumps({m: launches[f'{name}_{m}'] for m in steps})}")

        times = {mode: [] for mode in steps}
        for mode in STEP_ORDER:
            times[mode].append(_step_times(steps[mode], b,
                                           f"spill {name} {mode} step"))
        for mode, step in steps.items():
            key = f"{name}_{mode}"
            in_step[key] = _kernels_in_step(step)
            for kname in PATH_KERNELS[f"spill_{mode}"]:
                require(kname in in_step[key],
                        f"spill {name} {mode}: the profile names no {kname}")
            before = torch.cuda.memory_allocated(cuda)
            peak = _peak_bytes(step, [cuda])
            log(f"spill {name} {mode} step ({smi}): ms/batch (host clock + "
                f"sync) " + " / ".join(f"{t[0]:.3f}" for t in times[mode])
                + "; device time " + " / ".join(f"{t[1]:.3f}" for t in times[mode])
                + f" ms in {times[mode][0][2]:.0f} device kernels and copies"
                f"; H2D {SPILL_H2D[bi][mode]} bytes/batch; fallback "
                f"{int(outs[mode]['fallback'].sum())} of {b}; peak "
                f"{peak} bytes allocated ({peak - before} above the "
                f"{before} held: genome and inputs); hand kernels in the "
                f"step: " + "; ".join(
                    f"{kn} {ms:.4f} ms per call, {n:.0f} calls per step"
                    for kn, (ms, n) in in_step[key].items()))
        bucket_graphs = check_graphs(
            name, kw, {"table": (arrays, None, args["table"]),
                       "resident": (res_arrays, genome, args["resident"]),
                       "rev": (rev_arrays, None, args["rev"])},
            {mode: launches[f"{name}_{mode}"] for mode in steps}, times, smi)
        graph_in_step.update({f"{name}_{mode}": t
                              for mode, t in bucket_graphs.items()})
        del genome, args, steps, outs, moved_out
        torch.cuda.empty_cache()

    # the hostile-rate fuzz of the small bucket on the card
    t0 = time.perf_counter()
    counters = spill.new_counters()
    for seed in range(4):
        spill.hostile_rounds(seed, cuda, counters)
    ovf = spill.cluster_overflow_batch()
    out = fwd_batch(*batch_from_numpy(ovf, cuda), **spill.KW)
    ovf_counts = spill.new_counters()
    spill.check_batch(out, ovf, spill.expect_fwd, ovf_counts,
                      "cluster overflow")
    require(bool(out["fallback"][0]) and ovf_counts["exact"] > 0,
            f"cluster-overflow item: flagged {bool(out['fallback'][0])}, "
            f"{ovf_counts}")
    require(counters["exact"] > 0 and counters["fallback"] > 0,
            f"hostile fuzz on the card saw {counters}")
    log(f"spill: hostile-rate fuzz (seeds 0-3, small bucket, fwd / "
        f"resident / rev on the card, each unflagged item == the numpy "
        f"oracle == the C++ core): {_native_text(counters)}, 0 wrong; "
        f"cluster-overflow item flagged, {ovf_counts['exact']} exact "
        f"beside it; {time.perf_counter() - t0:.1f} s")
    return launches, in_step, graph_in_step


# ---------------------------------------------------------------- phase 5
_LIFTED = re.compile(
    r"Lifted (\d+) primary reads: (\d+) device work items, (\d+) host items "
    r"\((\d+) window/bucket fallbacks\)"
)
_LAUNCHES = re.compile(r"kernel launches: (\{.*\})")
_TIMING_LINES = ("Total Runtime:", "Resident genome:")


# A scenario's contig BAM, read BAM (or CRAM) and reference FASTA.
INPUTS = ("asm_to_ref.bam", "read_to_asm.bam", "ref.fa")


def _cli_cmd(module, d, tag, device, extra=(), env_extra=None, inputs=INPUTS):
    """The command line and environment of one CLI run on scenario ``d``
    (its ``inputs``, by name in ``d`` or by path)."""
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [
        sys.executable, "-m", module,
        "--assembly-to-ref", os.path.join(d, inputs[0]),
        "--read-to-assembly", os.path.join(d, inputs[1]),
        "--remapped-read-output", os.path.join(d, f"remapped_{tag}.bam"),
        "--unassembled-read-output", os.path.join(d, f"un_{tag}.bam"),
        "--ref", os.path.join(d, inputs[2]), "--device", device, *extra,
    ]
    return cmd, env


def _start(cmd, env, stdout=subprocess.DEVNULL):
    """Start a CLI as the leader of a new process group, so that ``_finish``
    can stop the workers it forks along with it."""
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=stdout,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish(p, what, timeout=600):
    """Wait for a CLI started by ``_start``, then kill whatever is left of
    its process group; returns its stderr and requires exit code 0."""
    try:
        _, err = p.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    require(p.returncode == 0, f"{what} exited {p.returncode}:\n{err[-3000:]}")
    return err


def _finish_all(procs) -> list:
    """``_finish`` for each (process, what) pair, in order; if one fails,
    the others' process groups are killed too.  Returns their stderrs."""
    try:
        return [_finish(p, what) for p, what in procs]
    finally:
        for p, _ in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()


def _cli(module, d, tag, device, extra=(), env_extra=None, inputs=INPUTS):
    t0 = time.perf_counter()
    err = _finish(_start(*_cli_cmd(module, d, tag, device, extra, env_extra,
                                   inputs)),
                  f"{module} --device {device} ({tag})")
    return time.perf_counter() - t0, err


_H2D = re.compile(r"H2D per batch: (\d+) bytes \((\w+) slots, (\d+) batches, "
                  r"rev_batches (\d+) of (\d+) bytes, batches per bucket "
                  r"\[([\d, ]+)\]\)")
_PYFEED = re.compile(r"Python feed: (\d+) device batches, rev_batches (\d+) "
                     r"\((?:host|device)-shift routing\); groups by "
                     r"kind/bucket/rows: (.+)")
_COMPILED = re.compile(r"Compiled steps: (\d+) \((CUDA graphs|eager) on "
                       r"([^)]*)\), (\d+) replays for (\d+) batches over "
                       r"(\d+) shards; warm-up and capture ([\d.]+) s")


def _graphs_text(err, what, processes=1) -> str:
    """Each of the ``processes`` processes (of either feed) whose log is
    ``err`` compiled its steps as CUDA graphs on the card and dispatched
    every batch as one replay per shard; a summary of their ``Compiled
    steps`` lines."""
    found = _COMPILED.findall(err)
    require(len(found) == processes,
            f"{what}: {len(found)} 'Compiled steps' lines for {processes} "
            f"processes:\n{err[-3000:]}")
    texts = []
    for graphs, how, devs, replays, batches, shards, capture_s in found:
        require(how == "CUDA graphs" and "cuda" in devs,
                f"{what}: steps compiled as {how} on {devs}")
        require(int(replays) == int(batches) * int(shards),
                f"{what}: {replays} replays for {batches} batches over "
                f"{shards} shards")
        texts.append(f"{graphs} CUDA graphs, {replays} replays for "
                     f"{batches} batches, warm-up and capture {capture_s} s")
    return "; ".join(texts)


def _python_feed_text(err, what) -> tuple[int, str]:
    """The Python feed's own lines: its groups by kind, bucket and rows
    (each row count a rung of ``group_rows``), their sum its device
    batches, every batch one replay of a CUDA graph (``_graphs_text``) and
    at most one graph per (kind, bucket, rows) met.  Returns the reverse
    batches and a summary."""
    pm = _PYFEED.search(err)
    require(pm is not None, f"{what}: no Python feed line:\n{err[-3000:]}")
    n_batches = int(pm.group(1))
    groups = {shape: int(n) for shape, n in
              (part.split(" x") for part in pm.group(3).split(", "))}
    require(n_batches > 0 and sum(groups.values()) == n_batches,
            f"{what}: groups {pm.group(3)} for {n_batches} device batches")
    for shape in groups:
        rows = int(shape.split("/")[2])
        require(rows >= 64 and rows & (rows - 1) == 0,
                f"{what}: a group of {rows} rows")
    text = _graphs_text(err, what)
    graphs, batches = (int(x) for x in _COMPILED.search(err).group(1, 5))
    require(batches == n_batches,
            f"{what}: {batches} compiled batches, {n_batches} device batches")
    require(1 <= graphs <= len(groups),
            f"{what}: {graphs} CUDA graphs for {len(groups)} (kind, bucket, "
            "rows) met")
    return int(pm.group(2)), (f"{n_batches} device batches, {pm.group(2)} "
                              f"reverse; groups {pm.group(3)}; {text}")


_SHARDING = re.compile(r"Sharding batches over (\d+) local devices")

# The CLI runs of phase 5: (path, --feed, environment).
E2E_RUNS = (
    ("resident", "native", {}),
    ("table", "native", {"PTPU_RESIDENT": "0"}),
    ("native_devshift", "native", {"PTPU_HOST_SHIFT": "0"}),
    ("shard_resident", "native", {"PTPU_SHARD": "1"}),
    ("shard_devshift", "native", {"PTPU_SHARD": "1", "PTPU_HOST_SHIFT": "0"}),
    ("python", "python", {}),
    ("python_devshift", "python", {"PTPU_HOST_SHIFT": "0"}),
)


def _feed_line(path, feed, err):
    """The feed's own stats line: slot mode and H2D bytes for the native
    feed, device batches for the Python feed; checks that reverse batches
    ran exactly under device-shift routing."""
    devshift = path.endswith("_devshift")
    if feed == "native":
        hm = _H2D.search(err)
        require(hm is not None, f"e2e {path}: no H2D line:\n{err[-3000:]}")
        mode = "resident" if path.endswith("resident") else "table"
        require(hm.group(2) == mode, f"e2e {path} run used {hm.group(2)} slots")
        n_rev = int(hm.group(4))
        text = (f"H2D {hm.group(1)} bytes/batch over {hm.group(3)} batches "
                f"({hm.group(2)} slots), {n_rev} reverse batches of "
                f"{hm.group(5)} bytes; {_graphs_text(err, f'e2e {path}')}")
    else:
        n_rev, text = _python_feed_text(err, f"e2e {path}")
    require((n_rev > 0) == devshift,
            f"e2e {path}: {n_rev} reverse batches under "
            f"{'device' if devshift else 'host'}-shift routing")
    return text


def _records(d, tag, cram=False):
    """The sorted records of run ``tag`` in ``d``; with ``cram``, as a CRAM
    input keeps them: ``=``/``X`` written as ``M``, unmapped MAPQ 0."""
    from portello_tpu_torch.testutil.spill import sam_records

    return {kind: sam_records(os.path.join(d, f"{kind}_{tag}.bam"),
                              zero_unmapped_mapq=cram and kind == "un",
                              collapse_eqx=cram)
            for kind in ("remapped", "un")}


def _same_records(d, tag, want, what, cram=False):
    """Run ``tag``'s records in ``d`` (``_records``) equal ``want``."""
    got = _records(d, tag, cram)
    for kind in ("remapped", "un"):
        require(got[kind] == want[kind], f"{what} {kind} records differ from "
                f"--device host ({len(got[kind])} vs {len(want[kind])} "
                "records)")


def _process_launches(errs, path, what):
    """The launch counts that each process of a run logged, one ``kernel
    launches`` line per process, each held to ``path``'s kernels; returns
    their sum."""
    found = [json.loads(m) for err in errs for m in _LAUNCHES.findall(err)]
    require(len(found) == len(PROCESSES[path]),
            f"{what}: {len(found)} kernel launches lines for "
            f"{len(PROCESSES[path])} processes")
    for name, launches in zip(PROCESSES[path], found):
        require_launches(launches, path, f"{what}, {name}")
    return {k: sum(f.get(k, 0) for f in found) for k in KERNELS}


def _log_lines(err, path, keys):
    for line in err.splitlines():
        if any(k in line for k in keys):
            log(f"e2e port CLI ({path}): " + line.split("] ", 1)[-1])


def _trace_kernels(trace_path):
    """Device kernel time (us) by kernel name in a Chrome trace of
    ``torch.profiler``.  A name loses its argument list and the
    ``(anonymous namespace)::`` that the hand kernels' names carry."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            name = name.split("(", 1)[0]
            by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0))
    return by_name


# The processes of each scale-out run, by name, in the order their logs are
# read.
PROCESSES = {
    "workers": ("worker 0", "worker 1"),
    "hosts": ("host 0", "host 1"),
    "profile": ("process",),
}
_SCALE_LINES = ("Resident genome:", "peak device memory:", "Total Runtime:",
                "Forking ", "Merged ", "torch.distributed initialized",
                "output shard:")


def phase_scale_out(d, want, threads, smi):
    """The scale-out and profiling flags on the bench scenario, each run's
    merged sorted records against ``--device host``'s: ``--local-workers
    2`` (two forked workers on one card, each with its own CUDA context and
    resident genome), two concurrent ``--num-hosts 2 --coordinator`` hosts
    joined over gloo and merged with ``merge_bams``, and ``--profile``,
    whose Chrome trace must name kernels 1 and 3."""
    from portello_tpu_torch.tools.merge import merge_bams
    from portello_tpu_torch.parallel.distributed import shard_output_path

    module = "portello_tpu_torch.main"
    half = str(max(1, int(threads) // 2))
    feed = ("--feed", "native")
    runs = {}

    wall, err = _cli(module, d, "workers", "cuda",
                     (*feed, "--threads", half, "--local-workers", "2"))
    require("Forking 2 workers" in err and "Merged 2 worker shards" in err,
            f"e2e workers: no fork or no merge in the log:\n{err[-3000:]}")
    require(not [f for f in os.listdir(d) if "_workers.shard" in f],
            "e2e workers: shard files left behind")
    runs["workers"] = _process_launches([err], "workers", "e2e workers")
    graphs_text = _graphs_text(err, "e2e workers", 2)
    _same_records(d, "workers", want, "e2e workers")
    _log_lines(err, "workers", _SCALE_LINES)
    log(f"e2e workers (--local-workers 2 --threads {half}, native feed, "
        f"resident): merged output == --device host output; both workers "
        f"launched compress and window_match; {graphs_text}; wall "
        f"{wall:.2f} s ({smi}); launches {json.dumps(runs['workers'])}")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    errs = _finish_all([
        (_start(*_cli_cmd(module, d, "hosts", "cuda", (
            *feed, "--threads", half, "--num-hosts", "2", "--host-id", str(h),
            "--coordinator", f"127.0.0.1:{port}"))), f"e2e host {h}")
        for h in range(2)
    ])
    wall = time.perf_counter() - t0
    for h, err in enumerate(errs):
        require(f"torch.distributed initialized: process {h}/2" in err,
                f"e2e host {h}: no rendezvous line:\n{err[-3000:]}")
        _log_lines(err, f"host {h}", _SCALE_LINES)
    runs["hosts"] = _process_launches(errs, "hosts", "e2e hosts")
    graphs_text = "; ".join(_graphs_text(err, f"e2e host {h}")
                            for h, err in enumerate(errs))
    t1 = time.perf_counter()
    for kind in ("remapped", "un"):
        out = os.path.join(d, f"{kind}_hosts.bam")
        merge_bams(out, [shard_output_path(out, h, 2) for h in range(2)])
    merge_s = time.perf_counter() - t1
    _same_records(d, "hosts", want, "e2e hosts")
    log(f"e2e hosts (2 concurrent --num-hosts 2 --coordinator processes, "
        f"--threads {half} each, gloo rendezvous): merged shards == --device "
        f"host output; {graphs_text}; wall {wall:.2f} s for both, merge "
        f"{merge_s:.2f} s ({smi}); launches {json.dumps(runs['hosts'])}")

    prof = os.path.join(d, "prof")
    wall, err = _cli(module, d, "profile", "cuda",
                     (*feed, "--threads", threads, "--profile", prof))
    runs["profile"] = _process_launches([err], "profile", "e2e profile")
    graphs_text = _graphs_text(err, "e2e profile")
    _same_records(d, "profile", want, "e2e profile")
    trace = os.path.join(prof, "trace.json")
    require(os.path.exists(trace), f"e2e profile: no trace at {trace}")
    by_name = _trace_kernels(trace)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    total = sum(by_name.values())
    log(f"e2e profile (--profile, native feed, resident): output == --device "
        f"host output; {graphs_text}, captured under the profiler; trace "
        f"{os.path.getsize(trace)} bytes; wall "
        f"{wall:.2f} s ({smi}); device kernel time {total / 1e3:.3f} ms in "
        f"{len(by_name)} kernel names; top 5: "
        + "; ".join(f"{n[:100]} {us / 1e3:.3f} ms" for n, us in top))
    for name in PATH_KERNELS["profile"]:
        kernel = KERNEL_FUNCTIONS[name]
        us = [t for n, t in by_name.items() if kernel in n]
        require(bool(us), f"e2e profile: the trace names no {kernel}")
        log(f"e2e profile: the trace names {kernel}, "
            f"{sum(us) / 1e3:.4f} ms of device time in the run")
    return runs


# Phase 5b's WGS-shaped scenario (testutil/spill.build_scenario, the shape of
# scripts/soak_scale.py): this seed and read count put batches in all three
# buckets and send items to the host.
WGS_READS = 3000
WGS_SEED = 2026
# Phase 5b's runs on it: (path, --feed, environment).
WGS_RUNS = (
    ("wgs_resident", "native", {}),
    ("wgs_table", "native", {"PTPU_RESIDENT": "0"}),
    ("wgs_devshift", "native", {"PTPU_HOST_SHIFT": "0"}),
    ("wgs_python", "python", {}),
)


def _spill_run(d, path, feed, env, want, threads, smi, inputs=INPUTS,
               extra=(), cram=False):
    """One phase-5b CLI run on ``--device cuda``: its sorted records equal
    to ``want`` (the port's ``--device host`` run; for a CRAM input, with
    ``=``/``X`` written as ``M`` and unmapped MAPQ 0 on both sides), its
    launches those of ``path``; on the native feed, the H2D bytes per batch
    those of its slots, bucket by bucket.  Returns (the item counts, the
    batches per bucket or None, the launches)."""
    wall, err = _cli("portello_tpu_torch.main", d, path, "cuda",
                     ("--feed", feed, "--threads", threads, *extra), env,
                     inputs)
    m = _LIFTED.search(err)
    lm = _LAUNCHES.search(err)
    require(m is not None and lm is not None,
            f"e2e {path}: the log lacks its stats lines:\n{err[-3000:]}")
    launches = json.loads(lm.group(1))
    require_launches(launches, path, f"e2e {path} run")
    _same_records(d, path, want, f"e2e {path}", cram)
    counts = dict(zip(("primary", "device", "host", "fallback"),
                      map(int, m.groups())))
    per_bucket = None
    feed_text = ""
    if feed == "native":
        hm = _H2D.search(err)
        require(hm is not None, f"e2e {path}: no H2D line:\n{err[-3000:]}")
        per_bucket = [int(x) for x in hm.group(6).split(",")]
        n_batches, n_rev = int(hm.group(3)), int(hm.group(4))
        require(sum(per_bucket) == n_batches,
                f"e2e {path}: batches per bucket {per_bucket}, {n_batches} "
                f"batches")
        if n_rev == 0:  # one slot kind: the mean follows from the buckets
            mode = hm.group(2)
            total = sum(n * SPILL_H2D[i][mode] for i, n in enumerate(per_bucket))
            require(int(hm.group(1)) == total // n_batches,
                    f"e2e {path}: {hm.group(1)} H2D bytes per batch, the "
                    f"slots of {per_bucket} give {total // n_batches}")
        feed_text = (f"; H2D {hm.group(1)} bytes/batch ({hm.group(2)} slots, "
                     f"{n_batches} batches, per bucket {per_bucket}, "
                     f"{n_rev} reverse of {hm.group(5)} bytes); "
                     f"{_graphs_text(err, f'e2e {path}')}")
    else:
        feed_text = "; " + _python_feed_text(err, f"e2e {path}")[1]
    _log_lines(err, path, _TIMING_LINES + ("peak device memory:",))
    log(f"e2e {path} (--feed {feed}{''.join(f' {k}={v}' for k, v in env.items())}"
        f"{''.join(' ' + a for a in extra)}): --device cuda output == "
        f"--device host output ({len(want['remapped'])} remapped records); "
        f"wall {wall:.2f} s for {counts['primary']} primary reads = "
        f"{counts['primary'] / wall:.1f} reads/s ({smi}); device items "
        f"{counts['device']}, host items {counts['host']}, fallbacks "
        f"{counts['fallback']}{feed_text}; launches {json.dumps(launches)}")
    return counts, per_bucket, launches


# Phase 5b's --target-region runs: the first 108 kb of the bench scenario's
# chr1 (200 kb), which holds some of its reads, not all.
REGION = ("--target-region", "chr1:1-108000")


def _clocked(fn, *args):
    """Worker job: ``fn(*args)`` and the seconds it took, so that the inputs'
    serial time can be logged beside the pool's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def bench_job(d) -> str:
    """Worker job: phase 5's bench scenario in ``d`` and a CRAM 3.1 copy of
    its reads; returns the CRAM's path."""
    import numpy as np

    from portello_tpu_torch.testutil.simulate import make_scenario
    from portello_tpu_torch.testutil.spill import write_crams

    make_scenario(d, rng=np.random.default_rng(99), n_reads_per_contig=400,
                  read_len=18000, chrom_len=200000)
    return write_crams(os.path.join(d, INPUTS[1]), ("31",))["31"]


def wgs_job(d) -> dict:
    """Worker job: phase 5b's WGS-shaped scenario in ``d`` and the fallback
    reads in ``d/fallback``."""
    import numpy as np

    from portello_tpu_torch.testutil.spill import build_inputs, build_scenario

    n = build_scenario(d, WGS_READS, np.random.default_rng(WGS_SEED))
    fb = os.path.join(d, "fallback")
    os.makedirs(fb)
    return {"n": n, "fallback": fb, "fallback_inputs": build_inputs(fb)}


def _host_cli(module, d, tag, threads, extra=(), inputs=INPUTS) -> float:
    """One ``--device host`` reference run, alone on the machine; logs and
    returns its wall seconds."""
    wall, _ = _cli(module, d, tag, "host", ("--threads", threads, *extra),
                   None, inputs)
    log(f"e2e: host-path CLI wall {wall:.2f} s ({module}, {tag} on "
        f"{os.path.basename(d)}, --threads {threads})")
    return wall


def phase_spill_e2e(inputs, threads, smi):
    """The spill path end to end on ``--device cuda``: the WGS-shaped
    scenario on both feeds, both slot modes and both routings, the fallback
    reads of ``testutil/spill.build_inputs`` under both routings, and CRAM
    3.1 and ``REGION`` inputs on phase 5's bench scenario; each run's
    records equal to the port's ``--device host``."""
    runs = {}
    d, d18 = inputs["wgs"], inputs["bench"]
    module = "portello_tpu_torch.main"
    _host_cli(module, d, "host", threads)
    want = _records(d, "host")
    for path, feed, env in WGS_RUNS:
        counts, per_bucket, runs[path] = _spill_run(
            d, path, feed, env, want, threads, smi)
        require(counts["host"] > 0, f"e2e {path}: no host items")
        if per_bucket is not None:
            require(all(per_bucket),
                    f"e2e {path}: batches per bucket {per_bucket}")

    fb = inputs["fallback"]
    _host_cli(module, fb, "host", threads, inputs=inputs["fallback_inputs"])
    want = _records(fb, "host")
    for path, env in (("fallback", {}),
                      ("fallback_devshift", {"PTPU_HOST_SHIFT": "0"})):
        counts, _, runs[path] = _spill_run(fb, path, "native", env, want,
                                           threads, smi,
                                           inputs["fallback_inputs"])
        require(counts["host"] > 0, f"e2e {path}: no host items")
    require(counts["fallback"] >= 1,
            f"e2e fallback_devshift: {counts['fallback']} fallbacks")

    cram_inputs = (INPUTS[0], inputs["cram"], INPUTS[2])
    _host_cli(module, d18, "region_host", threads, REGION)
    _, _, runs["cram"] = _spill_run(d18, "cram", "native", {},
                                    _records(d18, "port_host", cram=True),
                                    threads, smi, cram_inputs, cram=True)
    _, _, runs["region_bam"] = _spill_run(d18, "region_bam", "native", {},
                                          _records(d18, "region_host"),
                                          threads, smi, extra=REGION)
    _, _, runs["region_cram"] = _spill_run(
        d18, "region_cram", "native", {},
        _records(d18, "region_host", cram=True), threads, smi, cram_inputs,
        extra=REGION, cram=True)
    return runs


def phase_e2e(smi, inputs):
    """Phase 5 on the bench scenario, then phase 5b (``phase_spill_e2e``);
    ``inputs`` holds both scenarios' directories (``start_inputs``)."""
    import torch

    runs = {}
    d = inputs["bench"]
    threads = str(os.cpu_count() or 1)
    # the port's host path must equal the JAX package's, so every --device
    # cuda run below equals both
    _host_cli("portello_tpu.main", d, "host", threads)
    _host_cli("portello_tpu_torch.main", d, "port_host", threads)
    want = _records(d, "host")
    require(len(want["remapped"]) > 0, "e2e produced no remapped records")
    _same_records(d, "port_host", want, "e2e port --device host")
    log(f"e2e: port --device host output == portello_tpu --device host "
        f"output ({len(want['remapped'])} remapped records)")
    # Each CLI runs in its own process, whose launch counts start at 0;
    # it logs the launches of its phase-2 run ("kernel launches: {...}").
    for path, feed, env in E2E_RUNS:
        wall, err = _cli("portello_tpu_torch.main", d, path, "cuda",
                         ("--feed", feed, "--threads", threads), env)
        m = _LIFTED.search(err)
        lm = _LAUNCHES.search(err)
        require(m is not None and lm is not None,
                f"port CLI log lacks its stats lines:\n{err[-3000:]}")
        feed_text = _feed_line(path, feed, err)
        # only PTPU_SHARD=1 shards, over every visible GPU; unset, the
        # native feed of a multi-GPU machine says it uses one
        sm = _SHARDING.search(err)
        require((sm is not None) == ("PTPU_SHARD" in env),
                f"e2e {path}: Sharding line {'missing' if sm is None else 'present'}")
        n_gpus = torch.cuda.device_count()
        if feed == "native" and sm is None and n_gpus > 1:
            require(f"{n_gpus} local GPUs visible; batches run on" in err,
                    f"e2e {path}: no line saying {n_gpus} GPUs are visible")
            feed_text += f"; one GPU of {n_gpus} (PTPU_SHARD unset)"
        if sm is not None:
            n_shards = int(sm.group(1))
            require(n_shards == torch.cuda.device_count(),
                    f"e2e {path}: {n_shards} shards on "
                    f"{torch.cuda.device_count()} GPUs")
            feed_text += (f"; sharded over {n_shards} local devices" + (
                " (a one-shard mesh on this one-GPU machine: phase 4 "
                "runs two shards on one card)" if n_shards == 1 else ""))
        launches = json.loads(lm.group(1))
        require_launches(launches, path, f"e2e {path} run")
        _log_lines(err, path, _TIMING_LINES)
        _same_records(d, path, want, f"e2e {path}")
        n_primary, dev_items, host_items, fb_items = map(int, m.groups())
        log(f"e2e {path} (--feed {feed}{''.join(f' {k}={v}' for k, v in env.items())}"
            f"): --device cuda output == --device host output "
            f"({len(want['remapped'])} remapped records, sorted SAM); "
            f"port CLI wall {wall:.2f} s for {n_primary} primary reads = "
            f"{n_primary / wall:.1f} reads/s (whole process); device "
            f"items {dev_items}, host items {host_items}, fallbacks "
            f"{fb_items}; {feed_text}; launches {json.dumps(launches)}")
        runs[path] = launches
    runs.update(phase_scale_out(d, want, threads, smi))
    t0 = time.perf_counter()
    runs.update(phase_spill_e2e(inputs, threads, smi))
    log(f"e2e spill: phase 5b took {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------- phase 6
# Kernels the bench's line must show launched, per call of a leg: the
# headline forward leg on resident slots, and the table-step diagnostic.
BENCH_LAUNCHES = (("fwd", "cleanup_and_compress"), ("fwd", "window_match"),
                  ("rev_fwd", "cleanup_and_compress"),
                  ("rev_fwd", "window_match"), ("fwd_table", "match_run"),
                  ("fwd_eager", "window_match"),
                  ("rev_fwd_eager", "window_match"),
                  ("rev_devshift_chain", "match_run"))
BENCH_POSITIVE = ("value", "t_fwd_ms", "t_fwd_device_ms", "t_rev_fwd_ms",
                  "t_rev_fwd_device_ms", "baseline_reads_per_s",
                  "feed_reads_per_s", "e2e_reads_per_s", "lone_call_ms",
                  "host_probe_us", "t_fwd_eager_ms", "t_rev_fwd_eager_ms",
                  "t_fwd_eager_device_ms", "lone_call_eager_ms")
BENCH_E2E = ("feed_reads_per_s", "e2e_reads_per_s", "e2e_wall_s",
             "e2e_n_primary", "e2e_scenario", "feed_reads_per_s_runs",
             "e2e_reads_per_s_runs", "e2e_warmup_wall_s")


def phase_bench(name, smi_line):
    """Phase 6: the port's bench, ``python -m portello_tpu_torch.bench``,
    in a process group of its own on the card with its defaults (B=512 18 kb
    items, 1 s passes, 3 runs, the 10,000-read e2e leg run 3 times after a
    warm-up run); prints its JSON line and requires the resident graph on
    this card, launches of the hand kernels on the timed legs, finite
    positive times and rates, the native C++ baseline, and the e2e
    fields."""
    import math

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PTPU_BENCH_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as stdout:
        _finish(_start([sys.executable, "-m", "portello_tpu_torch.bench"],
                       env, stdout), "bench")
        stdout.seek(0)
        out = stdout.read()
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    require(len(lines) == 1, f"bench printed {len(lines)} JSON lines:\n{out}")
    print(lines[0], flush=True)
    line = json.loads(lines[0])
    require(line["graph"] == "resident", f"bench graph {line['graph']}")
    require(line["device"] == name, f"bench device {line['device']!r}")
    require(line["power_limit"] and line["power_limit"] in smi_line,
            f"bench power limit {line['power_limit']!r} not in {smi_line!r}")
    launches = line["kernel_launches_per_call"]
    for leg, kernel in BENCH_LAUNCHES:
        require(launches[leg][kernel] > 0, f"bench {leg}: no {kernel} launch")
    # a replay counts the launches its graph captured: the eager step's
    for leg in ("fwd", "rev_fwd"):
        require(launches[leg] == launches[f"{leg}_eager"],
                f"bench {leg}: launches per replay {launches[leg]}, per eager "
                f"call {launches[f'{leg}_eager']}")
    for key in BENCH_POSITIVE:
        v = line[key]
        require(isinstance(v, (int, float)) and math.isfinite(v) and v > 0,
                f"bench {key} = {v!r}")
    require(line["baseline_protocol"].startswith("median5-1t-native-mix"),
            f"bench baseline {line['baseline_protocol']!r}")
    missing = [k for k in BENCH_E2E if line.get(k) is None]
    require(not missing, f"bench line lacks {missing}")
    log(f"bench: {wall:.1f} s; value {line['value']} reads/s (spread "
        f"{line['value_spread']}, vs_baseline {line['vs_baseline']}), t_fwd "
        f"{line['t_fwd_ms']} ms sustained (graph) / {line['t_fwd_eager_ms']} "
        f"ms (eager) / {line['t_fwd_device_ms']} ms device (busy share "
        f"{line['device_busy_share']}), lone call {line['lone_call_ms']} ms "
        f"(graph) / {line['lone_call_eager_ms']} ms (eager), feed "
        f"{line['feed_reads_per_s']} "
        f"reads/s, e2e {line['e2e_reads_per_s']} reads/s; launches per call "
        f"{json.dumps(launches)}")
    return line


def start_inputs(pool, work) -> dict:
    """Submit to ``pool`` what phases 4b, 5 and 5b build on the CPU, so that
    it builds while the kernels do: the mid- and wide-bucket items
    (``testutil/spill.spill_jobs``), and in directories under ``work`` the
    bench scenario with its CRAM copy and the WGS-shaped one with the
    fallback reads (``bench_job``, ``wgs_job``), and the bench's own e2e
    scenario in its cache under ``.bench_cache/`` (phase 6).  ``take_inputs``
    collects them."""
    from portello_tpu_torch import bench
    from portello_tpu_torch.testutil import spill

    dirs = {name: os.path.join(work, name) for name in ("bench", "wgs")}
    for d in dirs.values():
        os.makedirs(d)
    return {
        "bench": pool.submit(_clocked, bench_job, dirs["bench"]),
        "wgs": pool.submit(_clocked, wgs_job, dirs["wgs"]),
        "bench_e2e": pool.submit(_clocked, bench._e2e_scenario_dir,
                                 bench.E2E_READS, bench.E2E_READLEN),
        "spill": {bi: [pool.submit(_clocked, spill.make_chunk, job)
                       for job in spill.spill_jobs(SEED + 40 + bi, 512, bi)]
                  for bi in SPILL_BUCKETS},
        "dirs": dirs, "t0": time.perf_counter(),
    }


def take_inputs(pending) -> dict:
    """Wait for ``start_inputs``' work; returns the spill batches by bucket,
    the scenarios' directories, the fallback reads' inputs and the CRAM
    copy of the bench reads."""
    from portello_tpu_torch.testutil.spill import concat_batches

    spill_s, batches = 0.0, {}
    for bi, futures in pending["spill"].items():
        chunks = [f.result() for f in futures]
        spill_s += sum(t for t, _ in chunks)
        batches[bi] = concat_batches(c for _, c in chunks)
    bench_s, cram = pending["bench"].result()
    wgs_s, wgs = pending["wgs"].result()
    bench_e2e_s, _ = pending["bench_e2e"].result()
    log(f"inputs, built in worker processes beside phases 2 and 4's batch, "
        f"all in {time.perf_counter() - pending['t0']:.1f} s of wall time; "
        f"{spill_s + bench_s + wgs_s + bench_e2e_s:.1f} s one after another: "
        f"the bench's e2e scenario (cached) {bench_e2e_s:.1f} s, 512 mid-bucket "
        f"and 512 wide-bucket items (make_item_arrays) {spill_s:.1f} s, the "
        f"bench scenario (4 contigs x 400 reads x 18 kb) and its CRAM 3.1 "
        f"copy {bench_s:.1f} s, the WGS-shaped scenario ({wgs['n']} reads of "
        f"2-60 kb, an indel per ~150 bp, 3 contigs on 3 + 1.5 Mbp) and the "
        f"fallback reads {wgs_s:.1f} s")
    return {"spill": batches, **pending["dirs"], "cram": cram,
            "fallback": wgs["fallback"],
            "fallback_inputs": wgs["fallback_inputs"]}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"[chip_smoke] FAIL: torch unavailable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    try:
        import numpy as np

        from portello_tpu_torch.testutil.spill import item_pool

        name, smi_line = phase_device()
        with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as work:
            # six workers build phases 4b, 5 and 5b's inputs during phase 2
            # and the HiFi batch, and are gone before anything is timed
            with item_pool(6) as pool:
                pending = start_inputs(pool, work)
                phase_build()
                rng = np.random.default_rng(SEED)
                rev_arrays = hifi_batch(rng)
                inputs = take_inputs(pending)
            kres = phase_kernels(rng, rev_arrays)
            step_launches, in_step, graph_in_step = phase_forward(
                rng, rev_arrays, smi_line)
            t0 = time.perf_counter()
            spill_launches, spill_in_step, spill_graph_in_step = (
                phase_spill_steps(smi_line, inputs["spill"]))
            log(f"spill: phase 4b took {time.perf_counter() - t0:.1f} s")
            e2e = phase_e2e(smi_line, inputs)
        phase_bench(name, smi_line)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "portello_tpu")]
        require(not leaked, f"imported {leaked[:5]}")
        log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    # launches: the main path's run (resident slots) for its kernels, the
    # table-slot run for match_run; launches_by_path: every CLI run's.
    # ms/plain_ms/bytes: phase 3's main-path shape of each kernel (kernel 1 at
    # the lift site, K=352; kernels 2 and 3 at C=96); launches_per_batch:
    # one resident step's (the main path's: 0 for match_run); step_ms: device
    # time per call inside the resident step (match_run: the table step);
    # spill_launches_per_batch and spill_step_ms: the same for each of phase
    # 4b's steps, by <bucket>_<step>.
    specs = (
        ("cleanup_and_compress", "compress.cu",
         "compress_pallas.py:124", "resident"),
        ("match_run", "match_run.cu", "match_run_pallas.py:78", "table"),
        ("window_match", "window_match.cu", "window_match.py:96", "resident"),
    )
    kernels = []
    for kernel, source, replaces, e2e_path in specs:
        ms, plain_ms, nbytes = kres[kernel]
        step = in_step["resident"].get(kernel) or in_step["table"].get(kernel)
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"portello_tpu_torch/csrc/{source}",
            "replaces": f"portello_tpu/kernels/pallas/{replaces}",
            "launches": e2e[e2e_path][kernel],
            "max_abs_err": kres[f"{kernel}_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None,
            "bytes": nbytes,
            "launches_per_batch": step_launches["resident"][kernel],
            "step_ms": step[0] if step else None,
            "replay_step_ms": {key: t[kernel][0]
                               for key, t in (
                                   *graph_in_step.items(),
                                   *spill_graph_in_step.items())
                               if kernel in t},
            "launches_by_path": {path: e2e[path][kernel] for path in e2e},
            "spill_launches_per_batch": {
                key: n.get(kernel, 0) for key, n in spill_launches.items()},
            "spill_step_ms": {key: t[kernel][0]
                              for key, t in spill_in_step.items()
                              if kernel in t},
        })
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
