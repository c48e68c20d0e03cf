#!/usr/bin/env python3
"""Where the swing of the bench's sustained step time comes from.

    python3 scripts/torch_bench_swing.py [--rounds 6] [--out FILE]

The bench (``python -m portello_tpu_torch.bench``) times its headline leg,
the resident forward step on B=512 18 kb items, by back-to-back eager calls
between CUDA events.  The step makes about 380 launches for 0.7 ms of
device work, so its time is the host's time to make them, and that time
moves between runs while the device time holds.  This script times the
same leg, on the bench's inputs (``fast_item_arrays`` and
``resident_timing_args``, seed 2026), in passes of ``bench.PASS_SECONDS``,
in rounds that interleave five conditions:

- ``plain``: as the bench times it;
- ``gc_off``: Python's garbage collector disabled during the pass;
- ``pinned``: the timing thread bound to one CPU core;
- ``loaded``: one spinning process per CPU core running beside it (other
  work on the host);
- ``probed``: as ``plain``, with the bench's host probe loop
  (``bench.probe_loop(bench.PROBE_LOOP)``) timed after every call, so the host CPU's
  speed is sampled over the same window as the step (its time is taken
  out of the ms per call, not out of its launch times).

Per pass it records two fixed pieces of host work timed around it (a
pure-Python loop and 500 eager CPU tensor ops: where they slow with the
step, the host's CPU ran slower), the ms per call (CUDA events), the
host's launch time per call (median, 99th percentile, max), the timing
thread's CPU time over
the pass's wall (below 1 when it waited off the CPU), its voluntary and
involuntary context switches, the host's steal share (``/proc/stat``: time
the hypervisor ran other guests on this guest's CPUs), the CPUs' mean clock
(``/proc/cpuinfo``), Python's garbage collections, the caching allocator's
device allocations, and the card's SM clock and power after the pass
(``nvidia-smi``).  Then it times ``bench.LONE_CALLS`` lone production calls
(the bench's ``dispatch_overhead_ms``) split into the slot arrays' H2D copy,
the step's launches and the wait for ``n_out``.

Prints the card's name and power limit, then one JSON summary (per
condition the median ms per call and its spread, the correlation of ms per
call with each host metric over all passes, the lone call's split), and
with ``--out``, writes every pass to that file.  Needs one card; under ``PTPU_BENCH_CPU=1``
(with the bench's size knobs, e.g. ``PTPU_BENCH_BATCH=8
PTPU_BENCH_READLEN=2000``) it rehearses on the CPU on the host clock.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONDITIONS = ("plain", "gc_off", "pinned", "loaded", "probed")
SMI = ("nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,pstate",
       "--format=csv,noheader")


def proc_stat() -> tuple[int, int]:
    """(steal, total) jiffies over every CPU of the host."""
    with open("/proc/stat") as f:
        vals = [int(v) for v in f.readline().split()[1:]]
    return vals[7] if len(vals) > 7 else 0, sum(vals[:8])


def cpu_mhz() -> float | None:
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
    except OSError:
        return None
    return round(statistics.mean(mhz), 1) if mhz else None


def cpu_probe_ms() -> tuple[float, float]:
    """Milliseconds of two fixed pieces of host work with no device in
    them: a pure-Python loop, and 500 eager adds of 4-element CPU tensors
    (the dispatcher's per-op path).  Where they slow with the step, the
    host's CPU itself ran slower."""
    import torch

    from portello_tpu_torch import bench

    t0 = time.perf_counter()
    bench.probe_loop(100000)
    t1 = time.perf_counter()
    a = torch.zeros(4)
    for _ in range(500):
        a = a + 1
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def gc_collections() -> int:
    return sum(s["collections"] for s in gc.get_stats())


def device_allocs(cuda: bool) -> int:
    if not cuda:
        return 0
    import torch

    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


def smi_after(cuda: bool) -> str | None:
    if not cuda:
        return None
    return subprocess.run(SMI, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def spinners(n: int) -> list[subprocess.Popen]:
    procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
             for _ in range(n)]
    time.sleep(0.3)
    return procs


def time_pass(step, cuda: bool, seconds: float, probe: bool = False) -> dict:
    """One pass of back-to-back calls for ``seconds`` of host time, with the
    host's state around it; with ``probe``, the in-pass probe after every
    call."""
    import torch

    from portello_tpu_torch import bench

    py0, op0 = cpu_probe_ms()
    ru0 = resource.getrusage(resource.RUSAGE_THREAD)
    steal0, total0 = proc_stat()
    gc0, alloc0, mhz0 = gc_collections(), device_allocs(cuda), cpu_mhz()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    cpu0 = time.thread_time()
    marks = [time.perf_counter()]
    probes = []
    while len(marks) == 1 or marks[-1] - marks[0] < seconds:
        step()
        if probe:
            t = time.perf_counter()
            bench.probe_loop(bench.PROBE_LOOP)
            probes.append(time.perf_counter() - t)
        marks.append(time.perf_counter())
    launch_cpu = time.thread_time() - cpu0
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (marks[-1] - marks[0]) * 1e3
    calls = len(marks) - 1
    ru1 = resource.getrusage(resource.RUSAGE_THREAD)
    steal1, total1 = proc_stat()
    per_call = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
    wall = marks[-1] - marks[0]
    mhz1 = cpu_mhz()
    py1, op1 = cpu_probe_ms()
    return {
        "calls": calls,
        "ms_per_call": (ms - sum(probes) * 1e3) / calls,
        "probe_in_pass_us": (statistics.median(probes) * 1e6
                             if probes else None),
        "launch_ms_p50": per_call[len(per_call) // 2],
        "launch_ms_p99": per_call[min(len(per_call) - 1,
                                      int(0.99 * len(per_call)))],
        "launch_ms_max": per_call[-1],
        "thread_cpu_share": launch_cpu / wall,
        "vol_switches": ru1.ru_nvcsw - ru0.ru_nvcsw,
        "invol_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
        "steal_share": (steal1 - steal0) / max(total1 - total0, 1),
        "cpu_mhz": (round((mhz0 + mhz1) / 2, 1)
                    if mhz0 is not None and mhz1 is not None else None),
        "gc_collections": gc_collections() - gc0,
        "device_allocs": device_allocs(cuda) - alloc0,
        "probe_py_ms": (py0 + py1) / 2,
        "probe_op_ms": (op0 + op1) / 2,
    }


def pearson(xs, ys) -> float | None:
    pairs = [(x, y) for x, y in zip(xs, ys) if x is not None and y is not None]
    if len(pairs) < 3:
        return None
    xs, ys = zip(*pairs)
    mx, my = statistics.mean(xs), statistics.mean(ys)
    sx = sum((x - mx) ** 2 for x in xs) ** 0.5
    sy = sum((y - my) ** 2 for y in ys) ** 0.5
    if sx == 0 or sy == 0:
        return None
    return round(sum((x - mx) * (y - my) for x, y in pairs) / (sx * sy), 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6,
                    help="rounds of the five conditions (default 6)")
    ap.add_argument("--out", help="write every pass to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from portello_tpu_torch import bench
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.pipeline_model import (
        bucket_kwargs,
        fwd_batch_resident,
        resident_batch_from_numpy,
    )
    from portello_tpu_torch.testutil.batchgen import HIFI_BUCKET

    device_kind = bench._device_kind_or_exit()
    cuda = device_kind == "cuda"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
            flush=True)
    batch = int(os.environ.get("PTPU_BENCH_BATCH", "512"))
    read_len = int(os.environ.get("PTPU_BENCH_READLEN", "18000"))
    table_mb = int(os.environ.get("PTPU_BENCH_TABLE_MB", "256"))
    dev = torch.device(device_kind)
    kw = bucket_kwargs(HIFI_BUCKET)
    rng = np.random.default_rng(2026)
    fwd_items = bench.fast_item_arrays(rng, batch, HIFI_BUCKET, read_len, rev=False)
    res_np, words = bench.resident_timing_args(fwd_items, rng, table_mb)
    genome = genome_tensor(words, dev)
    dev_args = resident_batch_from_numpy(res_np, dev)

    def step():
        return fwd_batch_resident(*dev_args, genome, **kw)

    for _ in range(bench.WARMUP_CALLS):
        step()
    ncpu = os.cpu_count() or 1
    core = sorted(os.sched_getaffinity(0))[-1]
    passes = []
    t_start = time.perf_counter()
    for r in range(args.rounds):
        for cond in CONDITIONS:
            procs, affinity = [], None
            if cond == "gc_off":
                gc.disable()
            elif cond == "pinned":
                affinity = os.sched_getaffinity(0)
                os.sched_setaffinity(0, {core})
            elif cond == "loaded":
                procs = spinners(ncpu)
            try:
                row = time_pass(step, cuda, bench.PASS_SECONDS,
                                probe=cond == "probed")
            finally:
                gc.enable()
                if affinity is not None:
                    os.sched_setaffinity(0, affinity)
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
            row.update(round=r, condition=cond,
                       t_s=round(time.perf_counter() - t_start, 2),
                       smi=smi_after(cuda))
            passes.append(row)
            sys.stderr.write(f"[swing] round {r} {cond}: "
                             f"{row['ms_per_call']:.3f} ms/call, cpu share "
                             f"{row['thread_cpu_share']:.3f}, steal "
                             f"{row['steal_share']:.4f}\n")

    # lone production calls, split: H2D of the slot arrays, the step's
    # launches, the wait for n_out
    split = {"h2d": [], "launch": [], "wait": [], "total": []}
    for i in range(bench.LONE_CALLS + 1):
        t0 = time.perf_counter()
        a = resident_batch_from_numpy(res_np, dev)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fwd_batch_resident(*a, genome, **kw)
        t2 = time.perf_counter()
        out["n_out"].cpu()
        t3 = time.perf_counter()
        if i:  # the first is a warm-up
            for k, v in (("h2d", t1 - t0), ("launch", t2 - t1),
                         ("wait", t3 - t2), ("total", t3 - t0)):
                split[k].append(v * 1e3)

    metrics = ("launch_ms_p50", "launch_ms_p99", "launch_ms_max",
               "thread_cpu_share", "vol_switches", "invol_switches",
               "steal_share", "cpu_mhz", "gc_collections", "device_allocs",
               "probe_py_ms", "probe_op_ms", "probe_in_pass_us", "t_s")
    ms = [p["ms_per_call"] for p in passes]
    unloaded = [p for p in passes if p["condition"] != "loaded"]
    summary = {
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "batch": batch, "pass_seconds": bench.PASS_SECONDS,
        "rounds": args.rounds,
        "by_condition": {},
        "corr_ms_with": {m: pearson(ms, [p[m] for p in passes])
                         for m in metrics},
        "corr_ms_with_unloaded": {
            m: pearson([p["ms_per_call"] for p in unloaded],
                       [p[m] for p in unloaded]) for m in metrics},
        "lone_call_ms_median": {k: round(statistics.median(v), 4)
                                for k, v in split.items()},
        "lone_call_ms_max": {k: round(max(v), 4) for k, v in split.items()},
    }
    for cond in CONDITIONS:
        rows = [p for p in passes if p["condition"] == cond]
        c_ms = [p["ms_per_call"] for p in rows]
        summary["by_condition"][cond] = {
            "ms_per_call_median": round(statistics.median(c_ms), 4),
            "ms_per_call_min": round(min(c_ms), 4),
            "ms_per_call_max": round(max(c_ms), 4),
            "spread": round(max(c_ms) / min(c_ms), 4),
            "thread_cpu_share_median": round(statistics.median(
                p["thread_cpu_share"] for p in rows), 4),
            "steal_share_max": round(max(p["steal_share"] for p in rows), 5),
            "invol_switches_median": statistics.median(
                p["invol_switches"] for p in rows),
            "launch_ms_p50_median": round(statistics.median(
                p["launch_ms_p50"] for p in rows), 4),
            "probe_op_ms_median": round(statistics.median(
                p["probe_op_ms"] for p in rows), 4),
            "corr_ms_with_probes": {
                m: pearson(c_ms, [p[m] for p in rows])
                for m in ("probe_py_ms", "probe_op_ms", "probe_in_pass_us")},
        }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "passes": passes}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
