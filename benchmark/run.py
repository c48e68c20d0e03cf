"""The benchmark of the PyTorch and CUDA port (``portello_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``benchmark/configs/``)
and a traffic mix (``benchmark/traffic/``); its inputs are generated from
the seed (``benchmark/gen/``, in a child process) and cached under
``benchmark/.cache/``.  Set-up reads the read BAM once into the page cache,
parses the reference once with the port's ``main.get_chrom_array``, and
makes one whole warm call of the cell's reads (which runs phase 1, writes
the ``--contig-index`` under ``TMPDIR`` and builds the native and CUDA
libraries in a checkout's first run).
The window then calls ``portello_tpu_torch.main.run`` back to back, each a
whole phase-2 lift of the cell's read BAM, for as long as ``--seconds``
lasts; every call that starts before then counts.  Afterwards the records
each call wrote are compared with ``benchmark/reference/``.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (each read by ``benchmark/metrics/<name>.py``) under
``torch.profiler``.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "portello_tpu")
SAMPLE_READS = 600      # reads drawn from the seed for the comparison
SAMPLE_EXTREMES = 16    # plus the longest reads, those of the highest bucket,
                        # the split ones and the unassembled ones


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return bench, cell, config, mix


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_environment(config: dict, trace: bool) -> None:
    """The program's switches from the configuration alone, and caches
    inside the checkout."""
    for k in [k for k in os.environ if k.startswith("PTPU_")]:
        del os.environ[k]
    os.environ.update(config["program"]["env"])
    if trace:
        os.environ["PTPU_FEED_TIMING"] = "1"
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, ".cache", "triton"))


def sample_names(meta: dict, seed: int) -> set[bytes]:
    """The reads compared: SAMPLE_READS drawn from the seed, and the longest,
    those that the generator puts in the highest bucket (the host fallback
    first, by their length and CIGAR ops), the split and the unassembled
    ones (SAMPLE_EXTREMES of each at most)."""
    from benchmark.gen.build import bucket_of, rng_for

    reads = meta["reads"]
    rng = rng_for(seed, 9)
    pick = set(rng.choice(len(reads), min(SAMPLE_READS, len(reads)),
                          replace=False).tolist())
    order = sorted(range(len(reads)), key=lambda i: -reads[i][1])
    pick.update(order[:SAMPLE_EXTREMES])
    mapped = [i for i, r in enumerate(reads) if r[2] != "unmapped"]
    order = sorted(mapped, key=lambda i: (-bucket_of(reads[i][1], reads[i][3]),
                                          -reads[i][3]))
    pick.update(order[:SAMPLE_EXTREMES])
    for kind in ("split", "unmapped"):
        pick.update([i for i, r in enumerate(reads) if r[2] == kind][:SAMPLE_EXTREMES])
    return {reads[i][0].encode() for i in pick}


def outputs(work: str, i: int) -> tuple[str, str]:
    """The two output BAMs of call ``i``."""
    return (os.path.join(work, f"call{i}.remapped.bam"),
            os.path.join(work, f"call{i}.unassembled.bam"))


def inputs(config: dict, mix: dict, seed: int, cache: str) -> dict:
    """The cell's inputs for ``seed``, built in a child process when they
    are not cached yet."""
    from benchmark.gen import build

    meta = build.cached(config, mix, seed, cache)
    if meta is None:
        job = {"config": config, "mix": mix, "seed": seed, "root": cache}
        subprocess.run([sys.executable, "-m", "benchmark.gen.build"], cwd=ROOT,
                       input=json.dumps(job).encode(), stdout=subprocess.DEVNULL,
                       check=True)
        meta = build.cached(config, mix, seed, cache)
    return meta


def page_in(*paths: str) -> None:
    """Reads each file once, so that every run's calls find it in the page
    cache, whether this run built it or an earlier one did."""
    buf = bytearray(16 << 20)
    for path in paths:
        with open(path, "rb", buffering=0) as f:
            while f.readinto(buf):
                pass


def cpu_seconds() -> float:
    """This process's CPU seconds so far, all threads."""
    t = os.times()
    return t.user + t.system


class Program:
    """The port behind its CLI's ``run``: one call is one phase-2 lift."""

    def __init__(self, config: dict, meta: dict, work: str, device: str):
        from portello_tpu_torch import main as pmain
        from portello_tpu_torch.pipeline import native_feed
        from portello_tpu_torch.utils.chrom_list import ChromList

        self.pmain, self.feed = pmain, native_feed
        self.config, self.meta, self.work = config, meta, work
        self.device = device
        self.index = os.path.join(work, "contigs.ptidx")
        logger = pmain.setup_logger()
        self.reference = pmain.get_chrom_array(
            meta["fasta"], ChromList.from_bam_filename(meta["contig_bam"]), logger)

    def call(self, reads_bam: str, i: int) -> dict:
        out_r, out_u = outputs(self.work, i)
        args = ["--assembly-to-ref", self.meta["contig_bam"],
                "--read-to-assembly", reads_bam,
                "--remapped-read-output", out_r,
                "--unassembled-read-output", out_u,
                "--ref", self.meta["fasta"], "--contig-index", self.index,
                *self.config["program"]["args"]]
        if self.device != "cuda":
            args[args.index("cuda")] = self.device
        settings = self.pmain.validate_and_fix_settings(self.pmain.parse_settings(args))
        self.pmain.validate_settings_data(settings)
        self.batch_size = settings.batch_size
        self.feed._last_stats = {}
        self.pmain.run(settings, preloaded_reference=self.reference)
        return dict(self.feed._last_stats)


def read_metrics(entries, ctx) -> dict:
    out = {}
    for m in entries:
        spec = importlib.util.spec_from_file_location(
            "bench_metric", os.path.join(HERE, "metrics", m["name"] + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def compare(meta: dict, names: set[bytes], written) -> dict:
    """The numbers compared, over every call's outputs: sampled reads whose
    records differ from the reference's, and records counted off."""
    from benchmark.reference.check import OutputScan, Reference

    want = Reference(meta["fasta"], meta["contig_bam"], meta["reads_bam"]).expected(names)
    differing = count_off = 0
    for out_r, out_u in written:
        sr, su = OutputScan(out_r, names), OutputScan(out_u, names)
        differing += sum((sr.records(n), su.records(n)) != want.get(n) for n in names)
        count_off += abs(sr.n_primary - meta["n_primary"])
        count_off += abs(su.n_records - meta["n_unmapped"])
    return {"reads_differing": differing, "records_count_off": count_off}


def control_readings(config: dict, mix: dict, seed: int, cache: str,
                     work: str) -> dict:
    """The control in the program's place, at the cell's size: every read
    lifted by the reference without its indel normalisation, written as the
    program's two output BAMs and judged by ``compare`` and ``LIMITS`` as a
    run's calls are."""
    from benchmark.gen import bamio
    from benchmark.reference.check import Reference

    meta = inputs(config, mix, seed, cache)
    names = sample_names(meta, seed)
    ref = Reference(meta["fasta"], meta["contig_bam"], meta["reads_bam"])
    remapped, unassembled = ref.lift_all(control=True)
    os.makedirs(work, exist_ok=True)
    out_r, out_u = outputs(work, 0)
    for path, recs, refs in ((out_r, remapped, ref.ref_chrom_list),
                             (out_u, unassembled, ref.contig_list)):
        f = bamio.BamFile(path, "@HD\tVN:1.6\n",
                          [(c.label, c.length) for c in refs.data])
        for tid, pos, end, raw in sorted(recs, key=lambda r: (r[0] < 0, r[0], r[1])):
            f.add(raw, tid, pos, end, tid < 0)
        f.close()
    checks = compare(meta, names, [(out_r, out_u)])
    checks["calls_failed"] = 0
    return {"correct": judge(checks, 1), "reads_sampled": len(names),
            "checks": {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}}


LIMITS = {"reads_differing": 0, "records_count_off": 0, "calls_failed": 0}


def judge(checks: dict, n_calls: int) -> bool:
    """``correct``: some call ran, and every number is within its limit."""
    return n_calls > 0 and all(checks[k] <= LIMITS[k] for k in LIMITS)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", chips_checked: bool = True,
             bench_spec=None, cache: str | None = None,
             work: str | None = None) -> dict:
    """One run; returns the result line's object.  ``device``,
    ``bench_spec`` (bench, cell, config, mix), ``cache`` and ``work`` (the
    directory of the calls' files) let a test drive it on the CPU at a small
    size."""
    t0 = time.perf_counter()
    bench, cell, config, mix = bench_spec or load_cell(workload)
    set_environment(config, trace)
    import torch

    if chips_checked and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell["chips"]):
        fail(f"{workload} needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    if device == "cuda":
        torch.cuda.init()
    import portello_tpu_torch.main  # noqa: F401  (the system under test)

    t_gen = time.perf_counter()
    meta = inputs(config, mix, seed, cache or os.path.join(HERE, ".cache", "inputs"))
    os.sync()  # no writeback of fresh inputs inside the window
    t_gen = time.perf_counter() - t_gen
    note(f"inputs ready in {t_gen:.2f} s: {meta['n_reads']} reads, "
         f"{meta['read_bases']} bases, bucket shares {meta['bucket_share']}")

    from benchmark.lib import trace as tr

    work = work or os.path.join(tempfile.gettempdir(), "portello_bench")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        page_in(meta["reads_bam"], meta["reads_bam"] + ".bai")
        prog = Program(config, meta, work, device)
        # one whole call of the cell's reads, as a user's long run is past
        # its first reads: it builds the native and CUDA libraries in a
        # checkout's first run, and takes the first call's slower start
        # (arenas, pinned buffers) out of the window
        prog.call(meta["reads_bam"], -1)
        for path in outputs(work, -1):
            os.remove(path)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0 - t_gen
        note(f"set-up {setup_s:.2f} s")

        calls, failed = [], 0
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections
        with tr.traced(trace) as prof:
            w0 = time.perf_counter()
            while time.perf_counter() - w0 < seconds:
                i = len(calls)
                c0, cpu0 = time.perf_counter(), cpu_seconds()
                try:
                    with tr.span(prof, i):
                        stats = prog.call(meta["reads_bam"], i)
                except Exception as e:  # a call that fails ends the window
                    print(f"call {i} failed: {e!r}", file=sys.stderr)
                    failed += 1
                    break
                calls.append({"wall": time.perf_counter() - c0, "stats": stats,
                              "cpu": cpu_seconds() - cpu0})
            if device == "cuda":
                torch.cuda.synchronize()
            window = time.perf_counter() - w0
        gc.unfreeze()
        note(f"window {window:.2f} s: {len(calls)} calls of "
             + ", ".join(f"{c['wall']:.2f}" for c in calls) + " s, of CPU "
             + ", ".join(f"{c['cpu']:.1f}" for c in calls) + " s")
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        found = forbidden_modules()
        if found:
            fail(f"modules loaded that the benchmark must not load: {found}", 3)
        ctx = {"calls": calls, "cell": cell, "config": config, "meta": meta,
               "window_s": window, "setup_s": setup_s, "batch_size": prog.batch_size,
               "trace": tr.reduce(prof) if prof is not None else None}
        del prof, prog

        t_check = time.perf_counter()
        names = sample_names(meta, seed)
        checks = compare(meta, names, [outputs(work, i) for i in range(len(calls))])
        checks["calls_failed"] = failed
        written = sum(os.path.getsize(p) for i in range(len(calls))
                      for p in outputs(work, i) if os.path.exists(p))
        note(f"comparison of {len(names)} reads over {len(calls)} calls in "
             f"{time.perf_counter() - t_check:.2f} s; the calls wrote "
             f"{written / 2**20:.1f} MiB")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    n_primary = sum(c["stats"]["n_primary"] for c in calls)
    if trace:
        metrics = read_metrics([m for m in bench["per_layer"]
                                if workload in m.get("workloads", [workload])], ctx)
    else:
        metrics = {"lifted_reads_per_s": {"value": n_primary / window if window else 0.0,
                                          "unit": "reads/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": judge(checks, len(calls)),
              "attempted": len(calls) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx["trace"]:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
