"""Throughput bench of the port: lifted reads/s on one CUDA GPU.

    python -m portello_tpu_torch.bench

Prints ONE JSON line on stdout: every key of the JAX package's ``bench.py``
line (``metric``, ``value`` in reads/s, ``vs_baseline`` and the rest, under
the same names), plus the device time per call and busy share, the kernel
launches per call, each leg's runs and spread, the lone calls' median and
quartiles, the host probe and CPU, and the card's power limit.  Progress
goes to stderr.

Workload: synthetic HiFi-like batches (default B=512 items of 18 kb reads,
~0.25% read-to-contig error, ~1.2/kb contig-to-ref variants) in the primary
bucket, through the forward step the native feed dispatches: under
host-shift routing (the default) the reverse-contig half is left-shifted on
the host by the exact C++ core (``ops/native_core.py``) and then runs the
same forward step.  On the card that step is ``fwd_batch_resident`` (the
genome resident on the device, packed read rows; kernels 1 and 3); under
``PTPU_BENCH_CPU=1`` it is the table step ``fwd_batch`` on the CPU, as the
JAX bench picks per backend.

Timing: the step runs as the native feed runs it, compiled
(``models/compiled.py``: captured once as a CUDA graph, one replay a call;
on the CPU the eager step), and beside it eagerly (the ``*_eager_*``
fields, the protocol of the first bench).  After three warm-up calls, each
pass makes back-to-back calls on device-resident inputs for
``PASS_SECONDS`` of host time, between two CUDA events recorded after a
synchronize; elapsed over the calls.  That is the sustained time per batch
a feed that keeps the card busy gets, host launch overhead included.  Per
run, one pass of each leg in turn, twice, best of the passes per leg; the
headline is the median run (``value_runs`` and ``t_*_ms_runs`` hold every
run, ``*_spread`` their max over min).  ``torch.profiler`` over a few more
calls gives the device time per call, which it sees inside a replay as in
an eager call.  The lone calls time one batch from host arrays: compiled
through the pinned staging of ``parallel/mesh.ShardedStep``, and eager.

The feed and end-to-end fields come from a child process that runs the
port's CLI (``--device cuda --feed native``, ``--device cpu`` under
``PTPU_BENCH_CPU=1``) once to warm up and then ``E2E_REPEATS`` times on a
cached simulated scenario, before this process touches the device, and
report the median run.

Env knobs: PTPU_BENCH_BATCH (512), PTPU_BENCH_READLEN (18000),
PTPU_BENCH_RUNS (3 on the card, 1 on the CPU), PTPU_BENCH_TABLE_MB (256),
PTPU_BENCH_CPU=1 (the CPU, no card needed), PTPU_BENCH_SKIP_E2E=1,
PTPU_BENCH_E2E_READS (10000), PTPU_BENCH_E2E_READLEN (18000),
PTPU_BENCH_E2E_THREADS; PTPU_BENCH_E2E=1 runs only one end-to-end CLI run,
PTPU_BENCH_OFFLOAD=1 the offload A/B.  Without ``PTPU_BENCH_CPU=1`` a
machine with no CUDA device exits non-zero; so does a native core that
does not build.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP_CALLS = 3
PROFILED_CALLS = 10
PASS_SECONDS = 1.0  # host time each timed pass makes calls for
LONE_CALLS = 20  # production calls from host arrays, for dispatch_overhead
E2E_REPEATS = 3  # warm CLI runs of the e2e leg, after one warm-up run
E2E_READS = 10000  # default e2e scenario: a warm run lasts over a second
E2E_READLEN = 18000
PROBE_LOOP = 2000  # iterations of the host probe's pure-Python loop
PROBE_TRIES = 200


def _log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def fast_item_arrays(rng, b, bcfg, read_len, rev, read_rate=0.0025, contig_rate=0.0012):
    """Vectorized synthetic work items (shape-realistic; content random).

    Kernel cost is data-independent given shapes (fixed scan lengths, fixed
    compare windows), so random window content is timing-faithful.  For the
    same generator state, the JAX bench's arrays."""
    from portello_tpu_torch.kernels.cigar_kernels import INT32_MAX, PAD
    from portello_tpu_torch.ops import cigar as cg
    from portello_tpu_torch.ops.blockmap import build_block_map

    margin = 64
    span = read_len + 2 * margin

    def sample_cigar(length, rate, max_events):
        n_ev = min(max(int(rng.poisson(length * rate)), 1), max_events)
        cuts = np.sort(rng.integers(1, length, size=n_ev))
        runs = np.diff(np.concatenate([[0], cuts, [length]]))
        runs = runs[runs > 0]
        codes = np.empty(2 * len(runs) - 1, dtype=np.int64)
        lens_ = np.empty_like(codes)
        codes[0::2] = cg.M
        lens_[0::2] = runs
        ev = rng.integers(0, 2, size=len(runs) - 1)
        codes[1::2] = np.where(ev == 0, cg.I, cg.D)
        lens_[1::2] = rng.integers(1, 4, size=len(runs) - 1)
        return np.stack([codes, lens_], axis=1)

    ops = np.full((b, bcfg.max_ops), PAD, np.int32)
    lens = np.zeros((b, bcfg.max_ops), np.int32)
    n_ops = np.zeros(b, np.int32)
    pos = np.full(b, margin // 2, np.int32)
    bk = np.full((b, bcfg.max_blocks), INT32_MAX, np.int32)
    bv = np.full((b, bcfg.max_blocks), -1, np.int32)
    nb = np.zeros(b, np.int32)
    ref_base = np.zeros(b, np.int32)
    ref_win = rng.integers(65, 85, size=(b, bcfg.max_seq), dtype=np.uint8)
    read_seq = rng.integers(65, 85, size=(b, bcfg.max_seq), dtype=np.uint8)
    win_base = np.zeros(b, np.int32)
    contig_win = (
        rng.integers(65, 85, size=(b, bcfg.max_seq), dtype=np.uint8) if rev else None
    )
    for i in range(b):
        # events cap just under the block budget (blocks ~ events + 1)
        ccig = sample_cigar(span, contig_rate, bcfg.max_blocks - 2)
        bm = build_block_map(0, ccig, False)
        k = min(len(bm), bcfg.max_blocks)
        bk[i, :k] = bm.keys[:k]
        bv[i, :k] = bm.vals[:k]
        nb[i] = k
        rcig = sample_cigar(read_len, read_rate, bcfg.max_ops // 2 - 2)
        n = min(len(rcig), bcfg.max_ops)
        ops[i, :n] = rcig[:n, 0]
        lens[i, :n] = rcig[:n, 1]
        n_ops[i] = n
    if rev:
        return (
            ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
            ref_win, ref_base, read_seq,
        )
    return ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq


def resident_timing_args(items_fwd, rng, table_mb):
    """Resident-form inputs paired to table-form forward items: a
    ``table_mb`` random superblock genome (the JAX package's (NSB, 16)
    uint32 words; ``kernels/resident.genome_tensor`` takes them as they
    are) with window origins scattered across it, plus the packed read
    rows.  For the same generator state, the JAX bench's arrays."""
    from portello_tpu_torch.kernels.resident import SB, pack_seq_rows

    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq = items_fwd
    b = len(n_ops)
    nsb = table_mb * (1 << 20) // SB
    words = rng.integers(0, 2**32, size=(nsb, SB // 4), dtype=np.uint32)
    g_sb = rng.integers(2, nsb - 4096, size=b, dtype=np.int64).astype(np.int32)
    g_off = rng.integers(0, SB, size=b, dtype=np.int32)
    packed = pack_seq_rows(np.asarray(read_seq))
    return (
        np.asarray(ops), np.asarray(lens), np.asarray(n_ops), np.asarray(pos),
        np.asarray(bk), np.asarray(bv), np.asarray(nb), g_sb, g_off,
        np.asarray(ref_base), packed,
    ), words


def probe_loop(n: int) -> int:
    acc = 0
    for i in range(n):
        acc += i
    return acc


def host_probe_us() -> float:
    """How fast the host's CPU runs now: the median microseconds of
    ``PROBE_TRIES`` runs of a fixed pure-Python loop.  The sustained step
    time is the host's time to make the step's launches, and it moves with
    this probe (``scripts/torch_bench_swing.py``)."""
    ts = []
    for _ in range(PROBE_TRIES):
        t0 = time.perf_counter()
        probe_loop(PROBE_LOOP)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


class Leg:
    """One timed step on fixed inputs: ``step()`` runs it once.  It keeps
    the calls it timed and the kernel launches they made (the wrappers'
    counts in ``kernels/_cuda.launch_counts``), so a run shows which
    kernels, hand-written or plain, it timed."""

    def __init__(self, step, cuda: bool):
        self.step = step
        self.cuda = cuda
        self.calls = 0
        self.launches: dict[str, int] = {}

    def sustained(self) -> float:
        """Seconds per call over back-to-back calls made for
        ``PASS_SECONDS`` of host time, after ``WARMUP_CALLS`` warm-up calls:
        between two CUDA events recorded after a synchronize on the card, on
        the host clock on the CPU (where every op has finished when it
        returns)."""
        import torch

        from portello_tpu_torch.kernels import _cuda

        for _ in range(WARMUP_CALLS):
            self.step()
        before = dict(_cuda.launch_counts)
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        calls = 0
        t0 = time.perf_counter()
        while calls == 0 or time.perf_counter() - t0 < PASS_SECONDS:
            self.step()
            calls += 1
        if self.cuda:
            end.record()
            end.synchronize()
            per_call = start.elapsed_time(end) / 1e3 / calls
        else:
            per_call = (time.perf_counter() - t0) / calls
        self.calls += calls
        for k, v in _cuda.launch_counts.items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        return per_call

    def launches_per_call(self) -> dict[str, float]:
        return {k: v / max(self.calls, 1) for k, v in self.launches.items()}

    def device_seconds(self) -> float:
        """Device time per call: every device activity (kernels, copies,
        memsets) ``torch.profiler`` records over ``PROFILED_CALLS`` calls.
        The profiler now and then records no device activity; after five
        such tries this raises."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_CALLS):
                    self.step()
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if dev:
                return sum(e.time_range.elapsed_us() for e in dev) / 1e6 / PROFILED_CALLS
        raise RuntimeError("torch.profiler recorded no device activity")


def timed_steps(kind, kw, inputs, genome=None):
    """The step the bench times, as (compiled, eager) callables over the
    same inputs already on the device: one replay of the step compiled
    over static copies of ``inputs`` (``models/compiled.py``; the eager
    step itself on the CPU), and one eager call on ``inputs``.  Both return
    the step's output dict."""
    from portello_tpu_torch.models.compiled import capture, step_function

    graph = capture(kind, kw, inputs, genome)
    fn = step_function(kind, kw)
    extra = () if genome is None else (genome,)
    return graph.replay, lambda: fn(*inputs, *extra)


def host_oracle_time(items_fwd, n_sample):
    """Single-thread exact host path on the same work items (reads/sec)."""
    from portello_tpu_torch.ops.blockmap import BlockMap
    from portello_tpu_torch.ops.liftover import liftover_read_alignment
    from portello_tpu_torch.ops.simplify import simplify_alignment_indels

    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq = items_fwd
    t0 = time.perf_counter()
    for i in range(n_sample):
        n = int(n_ops[i])
        cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
        k = int(nb[i])
        bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
        lifted = liftover_read_alignment(bm, int(pos[i]), cig)
        if lifted is not None:
            p, c = lifted
            simplify_alignment_indels(p - int(ref_base[i]), c, ref_win[i], read_seq[i])
    return n_sample / (time.perf_counter() - t0)


def native_baseline_time(items_fwd, max_out, n_threads):
    """Native (C++) reference-exact inner loop on the same work items
    (reads/sec), best of three."""
    from portello_tpu_torch.ops import native_core

    native_core.lift_simplify_batch(*items_fwd, max_out, n_threads=n_threads)  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native_core.lift_simplify_batch(*items_fwd, max_out, n_threads=n_threads)
        best = min(best, time.perf_counter() - t0)
    return len(items_fwd[2]) / best


def native_mix_time_median5(items_fwd, rev_fwd_items, rev_shift_args, max_out):
    """The pinned ``vs_baseline`` denominator protocol of the JAX bench:
    median of 5 single-thread runs of the native reference-exact work for
    the 50/50 mix (lift+simplify on the forward half, shift + lift+simplify
    on the reverse half), to be scaled by hardware threads (idealized
    linear scaling, the most favorable credible all-cores figure for the
    baseline).  Returns (mix_reads_per_s_1t, n_threads)."""
    from portello_tpu_torch.ops import native_core

    ops, lens, n_ops = items_fwd[:3]
    s_ops, s_lens, s_rel_pos, contig_win, s_read_seq = rev_shift_args
    samples = []
    native_core.lift_simplify_batch(*items_fwd, max_out, n_threads=1)  # warm
    for _ in range(5):
        t0 = time.perf_counter()
        native_core.lift_simplify_batch(*items_fwd, max_out, n_threads=1)
        native_core.shift_batch(
            s_ops, s_lens, n_ops, s_rel_pos, contig_win, s_read_seq,
            ops.shape[1], n_threads=1,
        )
        native_core.lift_simplify_batch(*rev_fwd_items, max_out, n_threads=1)
        samples.append(time.perf_counter() - t0)
    t_med = sorted(samples)[2]
    return 2 * len(n_ops) / t_med, max(native_core.hw_threads(), 1)


# ---------------------------------------------------------------- feed and e2e
FEED_PROTOCOL = (
    f"one warm-up CLI run, then the median over {E2E_REPEATS} CLI runs of "
    "n_primary / max(producer busy, finisher busy), the feed's t_native split; "
    "e2e = n_primary / CLI wall, median run"
)


def _e2e_scenario_dir(n_reads, read_len):
    """The simulated scenario of the e2e leg (seed 99, 4 contigs), built
    once and cached under ``.bench_cache/`` at the repository's root.  It
    is built in a temporary directory and renamed into place, so a build
    that was cut off leaves no half-written cache."""
    import shutil
    import tempfile

    root = os.path.join(REPO, ".bench_cache")
    cache = os.path.join(root, f"torch_e2e_{n_reads}_{read_len}")
    if not os.path.isdir(cache):
        from portello_tpu_torch.testutil.simulate import make_scenario

        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="building_", dir=root)
        _log(f"generating the e2e scenario in {cache}")
        try:
            make_scenario(
                tmp,
                rng=np.random.default_rng(99),
                n_reads_per_contig=max(n_reads // 3, 1),
                read_len=read_len,
                chrom_len=max(8 * read_len, 200000),
            )
            os.rename(tmp, cache)
        except OSError:
            if not os.path.isdir(cache):  # not another process's build
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return cache


def _cli_run(cache, device, threads=None):
    """One run of the port's CLI, native feed, on the scenario in
    ``cache``; returns its wall seconds and the feed's stats."""
    import shutil
    import tempfile

    from portello_tpu_torch.main import main as cli_main
    from portello_tpu_torch.pipeline import native_feed

    out = tempfile.mkdtemp(prefix="ptt_bench_")
    try:
        args = [
            "--assembly-to-ref", os.path.join(cache, "asm_to_ref.bam"),
            "--read-to-assembly", os.path.join(cache, "read_to_asm.bam"),
            "--remapped-read-output", os.path.join(out, "remapped.bam"),
            "--unassembled-read-output", os.path.join(out, "unassembled.bam"),
            "--ref", os.path.join(cache, "ref.fa"),
            "--device", device, "--feed", "native",
        ]
        if threads:
            args += ["--threads", str(threads)]
        t0 = time.perf_counter()
        cli_main(args)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return wall, dict(native_feed._last_stats)


def _feed_split(stats):
    """(producer busy, finisher busy) seconds of one run.  The scan loop
    (read + prepare + fill + drain handoff) and the finisher (encode +
    write) each run on their own thread, so the feed's sustainable rate is
    bounded by the slower of the two."""
    t_producer = sum(
        stats.get(f"t_native_{k}", 0.0) for k in ("read", "prepare", "fill", "drain")
    )
    return t_producer, stats.get("t_native_finish_enc", 0.0)


def measure_e2e_fields(device):
    """The feed and end-to-end fields: one warm-up CLI run (CUDA and library
    set-up; its wall under ``e2e_warmup_wall_s``), then ``E2E_REPEATS`` CLI
    runs on the cached scenario, each timed whole, with the feed's
    busy-time split (its stats' ``t_native_*``); the medians, and every run
    under ``*_runs``.

    The JAX bench derives the feed's capacity from one run; this one takes
    the median of several warm ones, so one burst of producer time does
    not set it."""
    n_reads = int(os.environ.get("PTPU_BENCH_E2E_READS", str(E2E_READS)))
    read_len = int(os.environ.get("PTPU_BENCH_E2E_READLEN", str(E2E_READLEN)))
    cache = _e2e_scenario_dir(n_reads, read_len)
    threads = os.cpu_count() or 4
    warmup_wall, _ = _cli_run(cache, device, threads)
    runs = [_cli_run(cache, device, threads) for _ in range(E2E_REPEATS)]
    rows = []
    for wall, stats in runs:
        n_primary = stats.get("n_primary", n_reads)
        t_producer, t_finisher = _feed_split(stats)
        t_cap = max(t_producer, t_finisher)
        rows.append({
            "feed": n_primary / t_cap if t_cap > 0 else None,
            "e2e": n_primary / wall, "wall": wall, "n_primary": n_primary,
            "t_producer": t_producer, "t_finisher": t_finisher,
            "t_dev": stats.get("t_dev", 0.0),
        })
    feeds = [r["feed"] for r in rows if r["feed"] is not None]
    med = sorted(rows, key=lambda r: r["e2e"])[(len(rows) - 1) // 2]
    return {
        "feed_reads_per_s": round(statistics.median(feeds), 1) if feeds else None,
        "e2e_reads_per_s": round(med["e2e"], 1),
        "e2e_wall_s": round(med["wall"], 3),
        "e2e_n_primary": med["n_primary"],
        "e2e_scenario": f"{n_reads}x{read_len // 1000}kb",
        "feed_capacity_protocol": FEED_PROTOCOL,
        "e2e_t_producer_s": round(med["t_producer"], 3),
        "e2e_t_finisher_s": round(med["t_finisher"], 3),
        "e2e_t_device_s": round(med["t_dev"], 3),
        "e2e_repeats": E2E_REPEATS,
        "e2e_warmup_wall_s": round(warmup_wall, 3),
        "feed_reads_per_s_runs": [
            round(r["feed"], 1) if r["feed"] is not None else None for r in rows],
        "e2e_reads_per_s_runs": [round(r["e2e"], 1) for r in rows],
        "e2e_wall_s_runs": [round(r["wall"], 3) for r in rows],
    }


def _e2e_fields_subprocess(device):
    """``measure_e2e_fields`` in a fresh interpreter, run before this
    process touches the device: the child builds the kernels (if they are
    not built) before this process loads them, so the two never wait on one
    build.  A failed child ends the bench."""
    p = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from portello_tpu_torch.bench import measure_e2e_fields; "
         "print('E2E_JSON ' + json.dumps(measure_e2e_fields(sys.argv[2])))",
         REPO, device],
        capture_output=True, text=True, timeout=1800,
    )
    for line in p.stdout.splitlines():
        if line.startswith("E2E_JSON ") and p.returncode == 0:
            return json.loads(line[len("E2E_JSON "):])
    raise RuntimeError(
        f"e2e leg failed (rc={p.returncode}):\n{p.stderr[-3000:]}")


def e2e_main():
    """One end-to-end CLI run (``PTPU_BENCH_E2E=1``) on the cached scenario,
    with the feed's busy-time split; or, under ``PTPU_BENCH_OFFLOAD=1``, the
    offload A/B: (a) the native feed with the exact host path on all cores
    (``PTPU_ALL_HOST=1``, no device step), (b) the feed on all cores but
    two plus the device, interleaved A, B, A, B, best of each."""
    device = _device_kind_or_exit()
    n_reads = int(os.environ.get("PTPU_BENCH_E2E_READS", str(E2E_READS)))
    read_len = int(os.environ.get("PTPU_BENCH_E2E_READLEN", str(E2E_READLEN)))
    cache = _e2e_scenario_dir(n_reads, read_len)
    ncpu = os.cpu_count() or 4

    if os.environ.get("PTPU_BENCH_OFFLOAD") == "1":
        walls_a, walls_b = [], []
        for _ in range(2):
            os.environ["PTPU_ALL_HOST"] = "1"
            walls_a.append(_cli_run(cache, device, ncpu)[0])
            os.environ["PTPU_ALL_HOST"] = "0"
            walls_b.append(_cli_run(cache, device, max(1, ncpu - 2))[0])
        del os.environ["PTPU_ALL_HOST"]
        wall_a, wall_b = min(walls_a), min(walls_b)
        print(json.dumps({
            "metric": f"offload A/B ({read_len // 1000}kb, {n_reads} reads)",
            "value": round(wall_a / wall_b, 3),
            "unit": "no-device wall / device wall (same machine)",
            "vs_baseline": None,
            "device": _device_label(device),
            "wall_allhost_s": round(wall_a, 3),
            "wall_device_s": round(wall_b, 3),
            "allhost_threads": ncpu,
            "device_feed_threads": max(1, ncpu - 2),
            "note": (
                "A = native feed + exact host path on all cores "
                "(PTPU_ALL_HOST=1); B = feed on ncpu-2 threads + device"
            ),
        }))
        return

    threads = int(os.environ.get("PTPU_BENCH_E2E_THREADS", str(ncpu)))
    wall, stats = _cli_run(cache, device, threads)
    n_primary = stats.get("n_primary", n_reads)
    t_producer, t_finisher = _feed_split(stats)
    t_cap = max(t_producer, t_finisher)
    print(json.dumps({
        "metric": f"end-to-end CLI reads/sec ({read_len // 1000}kb, native feed)",
        "value": round(n_primary / wall, 1),
        "unit": "reads/s",
        "vs_baseline": None,
        "device": _device_label(device),
        "wall_s": round(wall, 3),
        "n_primary": n_primary,
        "feed_reads_per_s": round(n_primary / t_cap, 1) if t_cap > 0 else None,
        "feed_capacity_protocol": (
            "n / max(producer scan-loop time, finisher encode+write time), "
            "one run"
        ),
        "t_producer_s": round(t_producer, 3),
        "t_finisher_s": round(t_finisher, 3),
        "t_blocked_prep_s": round(stats.get("t_prep", 0.0), 3),
        "t_device_s": round(stats.get("t_dev", 0.0), 3),
    }))


# ---------------------------------------------------------------- the bench
def _device_kind_or_exit() -> str:
    """``cpu`` under ``PTPU_BENCH_CPU=1``, else ``cuda``; exits non-zero when
    there is no CUDA device (nothing falls back to the CPU)."""
    if os.environ.get("PTPU_BENCH_CPU") == "1":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "[bench] no CUDA device; set PTPU_BENCH_CPU=1 to run on the CPU")
    return "cuda"


def _device_label(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def host_cpu() -> str | None:
    """The host CPU's model and nominal clock, from ``/proc/cpuinfo``."""
    try:
        with open("/proc/cpuinfo") as f:
            info = {k.strip(): v.strip() for k, v in
                    (ln.split(":", 1) for ln in f if ":" in ln)}
    except OSError:
        return None
    return " @ ".join(info[k] for k in ("model name", "cpu MHz")
                      if k in info) or None


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it (``700.00 W``)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return line.rsplit(",", 1)[-1].strip()


def _spread(xs):
    """Max over min of a leg's or a rate's runs (1.0 for one run)."""
    return round(max(xs) / min(xs), 4)


def main():
    device_kind = _device_kind_or_exit()
    cuda = device_kind == "cuda"
    batch = int(os.environ.get("PTPU_BENCH_BATCH", "512"))
    read_len = int(os.environ.get("PTPU_BENCH_READLEN", "18000"))

    # the e2e leg first, in a child, before this process touches the device
    e2e_fields = {}
    if os.environ.get("PTPU_BENCH_SKIP_E2E") != "1":
        e2e_fields = _e2e_fields_subprocess(device_kind)

    import torch

    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.compiled import StepCache
    from portello_tpu_torch.models.pipeline_model import (
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
        fwd_batch_resident,
        resident_batch_from_numpy,
        rev_batch_from_numpy,
    )
    from portello_tpu_torch.ops import native_core
    from portello_tpu_torch.parallel.mesh import sharded_step
    from portello_tpu_torch.pipeline.native_feed import host_shift_routing
    from portello_tpu_torch.testutil.batchgen import HIFI_BUCKET

    # The reverse leg's host shift and the baseline both need the C++ core.
    if native_core.get_lib() is None:
        raise RuntimeError(
            f"the native core did not build: {native_core.build_error()}")
    bcfg = HIFI_BUCKET
    kw = bucket_kwargs(bcfg)
    dev = torch.device(device_kind)
    rng = np.random.default_rng(2026)
    fwd_items = fast_item_arrays(rng, batch, bcfg, read_len, rev=False)
    rev_items = fast_item_arrays(rng, batch, bcfg, read_len, rev=True)
    # The routing as the native feed reads it (as its C++ scanner does: any
    # value starting with 0 is device shift), since the bench times what
    # that feed runs; the JAX bench reads it as != "0".
    host_shift = host_shift_routing()
    label = _device_label(device_kind)
    _log(f"device: {label}, batch={batch}, pass={PASS_SECONDS} s, "
         f"host_shift={host_shift}")

    # The production graph: resident slots on the card (the native feed's
    # default), the table step on the CPU, as the JAX bench picks per backend.
    resident = cuda
    table_mb = int(os.environ.get("PTPU_BENCH_TABLE_MB", "256"))
    if resident:
        res_fwd_np, words_np = resident_timing_args(fwd_items, rng, table_mb)
        genome = genome_tensor(words_np, dev)
        dev_res_fwd = resident_batch_from_numpy(res_fwd_np, dev)

    # The reverse-contig half under host-shift routing: left-shifted on the
    # host by the native core (as both feeds do during prep), then the same
    # forward step.  Its host cost is measured here (median of 5).
    (r_ops, r_lens, r_n_ops, r_pos, r_wb, r_cwin, r_bk, r_bv, r_nb,
     r_rwin, r_rbase, r_rseq) = rev_items
    rel_pos = (r_pos - r_wb).astype(np.int32)
    shift_args = (r_ops, r_lens, r_n_ops, rel_pos, r_cwin, r_rseq)
    nthreads = max(native_core.hw_threads(), 1)

    def _shift_median5(n_threads):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            native_core.shift_batch(*shift_args, bcfg.max_ops, n_threads=n_threads)
            ts.append(time.perf_counter() - t0)
        return batch / sorted(ts)[2]

    sh_codes, sh_lens, sh_n, sh_pos = native_core.shift_batch(
        *shift_args, bcfg.max_ops, n_threads=nthreads
    )
    host_shift_1t_rps = _shift_median5(1)
    host_shift_nt_rps = _shift_median5(nthreads)
    # overflow rows (shifted runs > max_ops; host fallback in production)
    # keep their unshifted cigar for shape-honest timing
    ov = sh_n < 0
    sh_codes[ov], sh_lens[ov] = r_ops[ov], r_lens[ov]
    sh_n[ov], sh_pos[ov] = r_n_ops[ov], rel_pos[ov]

    rev_fwd_items = (
        sh_codes, sh_lens, sh_n, (sh_pos + r_wb).astype(np.int32),
        r_bk, r_bv, r_nb, r_rwin, r_rbase, r_rseq,
    )
    if resident:
        res_rev_np, _ = resident_timing_args(rev_fwd_items, rng, table_mb)
        dev_res_rev = resident_batch_from_numpy(res_rev_np, dev)
        step_kind, step_genome = "fwd_resident", genome
        fwd_in, rev_in = dev_res_fwd, dev_res_rev
        graph = "resident"
    else:
        step_kind, step_genome = "fwd", None
        fwd_in = batch_from_numpy(fwd_items, dev)
        rev_in = batch_from_numpy(rev_fwd_items, dev)
        graph = "table"
    fwd_step, fwd_eager = timed_steps(step_kind, kw, fwd_in, step_genome)
    rev_step, rev_eager = timed_steps(step_kind, kw, rev_in, step_genome)
    # the compiled legs (what the native feed runs) and the eager protocol
    legs = {"fwd": Leg(fwd_step, cuda), "rev_fwd": Leg(rev_step, cuda),
            "fwd_eager": Leg(fwd_eager, cuda),
            "rev_fwd_eager": Leg(rev_eager, cuda)}

    # Sustained per-batch times, interleaved passes (each leg in turn,
    # twice), best of the passes per leg; the whole repeats
    # PTPU_BENCH_RUNS times and the headline is the median run.
    n_runs = max(int(os.environ.get("PTPU_BENCH_RUNS", "3" if cuda else "1")), 1)
    n_passes = 2
    run_times, probes = [], []
    for run_i in range(n_runs):
        t = {name: [] for name in legs}
        for _ in range(n_passes):
            for name, leg in legs.items():
                t[name].append(leg.sustained())
        run_times.append({name: min(ts) for name, ts in t.items()})
        probes.append(host_probe_us())
        _log(f"run {run_i + 1}/{n_runs}: " + " ".join(
            f"t_{name}={ts * 1e3:.3f} ms" for name, ts in run_times[-1].items())
            + f" host probe={probes[-1]:.2f} us")
    run_pairs = [(r["fwd"], r["rev_fwd"]) for r in run_times]

    launches = {name: leg.launches_per_call() for name, leg in legs.items()}
    t_fwd_dev = t_rev_dev = t_fwd_table = t_rev_devshift = None
    t_fwd_eager_dev = t_rev_eager_dev = None
    if cuda:
        t_fwd_dev = legs["fwd"].device_seconds()
        t_rev_dev = legs["rev_fwd"].device_seconds()
        t_fwd_eager_dev = legs["fwd_eager"].device_seconds()
        t_rev_eager_dev = legs["rev_fwd_eager"].device_seconds()
        # Diagnostics, one pass each, compiled: the table step (the native
        # feed's PTPU_RESIDENT=0 slots) and the device-shift reverse chain
        # (the PTPU_HOST_SHIFT=0 routing), both on table slots.
        table_leg = Leg(timed_steps("fwd", kw, batch_from_numpy(
            fwd_items, dev))[0], cuda)
        t_fwd_table = table_leg.sustained()
        chain_leg = Leg(timed_steps("rev", kw, rev_batch_from_numpy(
            rev_items, dev))[0], cuda)
        t_rev_devshift = chain_leg.sustained()
        launches["fwd_table"] = table_leg.launches_per_call()
        launches["rev_devshift_chain"] = chain_leg.launches_per_call()

    # the 50/50 forward/reverse mix under the routing, per run; headline =
    # the median run (ties to the lower mix time on even counts)
    def _mix_time(tf, tr):
        if host_shift or t_rev_devshift is None:
            return 0.5 * tf + 0.5 * tr
        return 0.5 * tf + 0.5 * t_rev_devshift

    if host_shift:
        mix_formula = "v3-host-shift: 0.5*t_fwd + 0.5*t_rev_fwd(shifted)"
    else:
        mix_formula = "v2-device-shift: 0.5*t_fwd + 0.5*t_rev_chain"
    run_mixes = [_mix_time(tf, tr) for tf, tr in run_pairs]
    value_runs = [round(batch / tm, 1) for tm in run_mixes]
    med_i = sorted(range(n_runs), key=lambda i: run_mixes[i])[(n_runs - 1) // 2]
    t_fwd, t_rev_fwd = run_pairs[med_i]
    reads_per_s = batch / run_mixes[med_i]

    # Production calls from host arrays, one at a time, each on the host
    # clock after a warm-up call (the genome already resident).  Compiled,
    # as the native feed dispatches a batch: the slot arrays into pinned
    # staging, their copy to the card, one replay and every output field
    # back to pinned host buffers (``parallel/mesh.ShardedStep``).  Eager:
    # the slot arrays' pageable copies, the eager step and n_out back.
    if resident:
        host_in, lone_genomes = res_fwd_np, [genome]

        def _eager_call():
            args = resident_batch_from_numpy(res_fwd_np, dev)
            return fwd_batch_resident(*args, genome, **kw)["n_out"].cpu()
    else:
        host_in, lone_genomes = fwd_items, None

        def _eager_call():
            return fwd_batch(*batch_from_numpy(fwd_items, dev), **kw)["n_out"].cpu()
    lone_step = sharded_step(StepCache(), step_kind, [dev], batch, kw,
                             lone_genomes)

    def _lone(call):
        call()
        ts = []
        for _ in range(LONE_CALLS):
            t0 = time.perf_counter()
            call()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), statistics.quantiles(ts, n=4)

    lone, lone_q = _lone(lambda: lone_step.submit(*host_in).wait())
    lone_eager, lone_eager_q = _lone(_eager_call)
    dispatch_overhead = lone - t_fwd

    host_rps = host_oracle_time(fwd_items, n_sample=min(24, batch))
    native_mix_1t, _ = native_mix_time_median5(
        fwd_items, rev_fwd_items, (r_ops, r_lens, rel_pos, r_cwin, r_rseq),
        kw["max_out"],
    )
    native_1 = native_baseline_time(fwd_items, kw["max_out"], 1)
    native_n = native_baseline_time(fwd_items, kw["max_out"], nthreads)
    timing = ("CUDA events around back-to-back CUDA graph replays"
              if cuda else "host clock around back-to-back eager calls on the CPU")
    baseline_rps = native_mix_1t * nthreads
    vs_baseline = reads_per_s / baseline_rps
    baseline_protocol = (
        f"median5-1t-native-mix x {nthreads} hw threads "
        "(pinned; BASELINE.md r3)"
    )
    note = (
        "baseline = native C++ reference-exact inner loop on the same "
        "50/50 mix (shift+lift+simplify; median-of-5 single-thread x "
        f"{nthreads} threads, idealized scaling); value is the "
        f"production host-shift routing mix; sustained time by {timing}"
    )
    protocol = (
        f"{'cuda-events' if cuda else 'host-clock'}: {WARMUP_CALLS} warm-up "
        f"calls, then back-to-back calls on device-resident inputs for "
        f"{PASS_SECONDS} s of host time, elapsed / calls (host launch "
        f"overhead included): t_* one CUDA graph replay a call "
        f"({'captured' if cuda else 'on the CPU the eager step'}), "
        f"t_*_eager_* eager calls; best of {n_passes} interleaved passes "
        f"per run, median of {n_runs} runs"
        + (f"; device time: torch.profiler over {PROFILED_CALLS} calls"
           if cuda else "")
        + f"; lone calls: median of {LONE_CALLS} from host arrays, "
        "compiled through pinned staging and eager"
        + f"; host probe: median of {PROBE_TRIES} {PROBE_LOOP}-iteration "
        "Python loops after each run's passes"
    )

    def _ms(t):
        return round(t * 1e3, 4) if t is not None else None

    print(json.dumps({
        "metric": (
            f"lifted reads/sec/device ({read_len // 1000}kb HiFi-like, "
            "fwd+rev pipeline, sustained)"
        ),
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs_baseline, 4),
        "note": note,
        "protocol": protocol,
        "value_runs": value_runs,
        "value_spread": _spread(value_runs),
        "n_runs": n_runs,
        "mix_formula": mix_formula,
        "baseline_protocol": baseline_protocol,
        "baseline_reads_per_s": round(baseline_rps, 1),
        "device": label,
        "power_limit": power_limit() if cuda else None,
        "batch": batch,
        "graph": graph,
        "resident_table_mb": table_mb if resident else None,
        "t_fwd_ms": _ms(t_fwd),
        "t_fwd_ms_runs": [_ms(tf) for tf, _ in run_pairs],
        "t_fwd_ms_spread": _spread([tf for tf, _ in run_pairs]),
        "t_fwd_device_ms": _ms(t_fwd_dev),
        "t_fwd_table_ms": _ms(t_fwd_table),
        "t_rev_fwd_ms": _ms(t_rev_fwd),
        "t_rev_fwd_ms_runs": [_ms(tr) for _, tr in run_pairs],
        "t_rev_fwd_ms_spread": _spread([tr for _, tr in run_pairs]),
        "t_rev_fwd_device_ms": _ms(t_rev_dev),
        "t_rev_devshift_chain_ms": _ms(t_rev_devshift),
        **{f"t_{leg}_ms{suffix}": value
           for leg in ("fwd_eager", "rev_fwd_eager")
           for suffix, value in (
               ("", _ms(run_times[med_i][leg])),
               ("_runs", [_ms(r[leg]) for r in run_times]),
               ("_spread", _spread([r[leg] for r in run_times])))},
        "t_fwd_eager_device_ms": _ms(t_fwd_eager_dev),
        "t_rev_fwd_eager_device_ms": _ms(t_rev_eager_dev),
        "calls_per_pass": round(legs["fwd"].calls / (n_runs * n_passes), 1),
        "host_probe_us": round(probes[med_i], 3),
        "host_probe_us_runs": [round(p, 3) for p in probes],
        "host_cpu": host_cpu(),
        "device_busy_share": (
            round((t_fwd_dev + t_rev_dev) / (t_fwd + t_rev_fwd), 4)
            if cuda else None
        ),
        "kernel_launches_per_call": launches,
        "dispatch_overhead_ms": _ms(dispatch_overhead),
        "lone_call_ms": _ms(lone),
        "lone_call_ms_quartiles": [_ms(lone_q[0]), _ms(lone_q[2])],
        "lone_call_eager_ms": _ms(lone_eager),
        "lone_call_eager_ms_quartiles": [_ms(lone_eager_q[0]),
                                         _ms(lone_eager_q[2])],
        "host_shift_1t_reads_per_s": round(host_shift_1t_rps, 1),
        "host_shift_nt_reads_per_s": round(host_shift_nt_rps, 1),
        "host_oracle_reads_per_s": round(host_rps, 1),
        "native_mix_1t_reads_per_s": round(native_mix_1t, 1),
        "native_1t_reads_per_s": round(native_1, 1),
        "native_nt_reads_per_s": round(native_n, 1),
        "native_threads": nthreads,
        **e2e_fields,
    }))


if __name__ == "__main__":
    if (
        os.environ.get("PTPU_BENCH_E2E") == "1"
        or os.environ.get("PTPU_BENCH_OFFLOAD") == "1"
    ):
        e2e_main()
    else:
        main()
