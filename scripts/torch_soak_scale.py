"""WGS-shaped scale soak of the PyTorch port, with memory accounting.

The port of ``scripts/soak_scale.py``.  Builds a scenario of mixed 2-60 kb
reads (log-uniform) at an indel density that spills long reads from the
primary bucket to the mid and wide buckets (``testutil/spill.build_scenario``),
then drives ``python -m portello_tpu_torch.main``:

  1. ``--device host``, the exact host path: the baseline (the JAX script
     compared its two device legs only with each other);
  2. the native feed on the device (``--device cuda`` unless ``--device
     cpu``), ``--threads 4``;
  3. the same with ``--local-workers 2`` (forked workers, shards merged);
  4. ``tools.sort`` over the outputs of legs 2 and 3, ``tools.merge`` over
     the sorted pair.

Each leg reports its wall clock, peak RSS (self and children, so forked
workers count), peak device memory (the CLI's ``peak device memory`` line,
the largest over its processes), device, host and fallback items and
batches per bucket (summed over processes); the ``--local-workers`` leg
also the primary reads of each worker, the workers' wall and the merge's.  The device legs' records must
equal the host leg's (an order-insensitive digest).  A half-size run is
recorded beside the full one, so memory that grows with the input shows.

    python scripts/torch_soak_scale.py [n_reads] [--skip-half] [--device cuda|cpu]

The scenario is written under ``.bench_cache/torch_soak_scale_<n>/`` and
reused when present; prints one JSON summary line at the end.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.join(HERE, "..")
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

_WRAP = r"""
import resource, sys
from portello_tpu_torch.main import main
try:
    main(sys.argv[1:])
finally:
    r = resource.getrusage(resource.RUSAGE_SELF)
    c = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"PEAK_RSS_KB {max(r.ru_maxrss, c.ru_maxrss)}", file=sys.stderr)
"""

_LIFTED = re.compile(
    r"Lifted (\d+) primary reads: (\d+) device work items, (\d+) host "
    r"items \((\d+) window/bucket fallbacks\)")
_BUCKETS = re.compile(r"batches per bucket \[([\d, ]+)\]")
_DEVICE_MEM = re.compile(r"peak device memory: ([\d.]+) MiB")
_MERGED = re.compile(r"Merged \d+ worker shards in ([\d.]+) s \(the workers "
                     r"took ([\d.]+) s\)")


def run_cli(args):
    """One CLI run; returns its record: wall, peak RSS, peak device memory
    and the item and batch counts summed over its processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", _WRAP, *args], env=env,
                       capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-4000:])
        raise SystemExit(f"CLI leg failed rc={p.returncode}")
    rec = {"wall_s": round(wall, 1)}
    m = re.search(r"PEAK_RSS_KB (\d+)", p.stderr)
    rec["peak_rss_mb"] = int(m.group(1)) // 1024 if m else None
    mem = [float(x) for x in _DEVICE_MEM.findall(p.stderr)]
    rec["peak_device_mib"] = max(mem) if mem else None
    lifted = _LIFTED.findall(p.stderr)
    if lifted:
        sums = np.sum(np.array(lifted, np.int64), axis=0)
        rec.update(zip(("n_primary", "device_items", "host_items",
                        "fallbacks"), map(int, sums)))
        if len(lifted) > 1:
            rec["primary_per_process"] = [int(x[0]) for x in lifted]
    m = _MERGED.search(p.stderr)
    if m:  # --local-workers: the workers' wall, then the merge's
        rec["workers_s"], rec["merge_s"] = float(m.group(2)), float(m.group(1))
    per_bucket = [[int(x) for x in b.split(",")]
                  for b in _BUCKETS.findall(p.stderr)]
    if per_bucket:
        rec["batches_per_bucket"] = [int(x) for x in
                                     np.sum(per_bucket, axis=0)]
    return rec


def digest_bam(path):
    """Order-insensitive record digest and count (sum of per-record hashes)."""
    from portello_tpu_torch.io.bam import BamReader

    total = 0
    n = 0
    with BamReader(path) as r:
        for rec in r:
            h = hashlib.sha1(rec.to_sam(r.header).encode()).digest()[:8]
            total = (total + int.from_bytes(h, "little")) & (2**64 - 1)
            n += 1
    return total, n


def run_scale(n_reads, rng_seed, device):
    from portello_tpu_torch.testutil.spill import build_scenario

    root = os.path.join(REPO, ".bench_cache", f"torch_soak_scale_{n_reads}")
    marker = os.path.join(root, ".done")
    rec = {"n_reads": n_reads, "device": device}
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        n_written = build_scenario(root, n_reads,
                                   np.random.default_rng(rng_seed))
        with open(marker, "w") as f:
            f.write(str(n_written))
        rec["build_s"] = round(time.perf_counter() - t0, 1)
        sys.stderr.write(f"[torch_soak_scale] built {n_written} reads in "
                         f"{rec['build_s']}s\n")
    out = tempfile.mkdtemp(prefix="torch_soakscale_")
    base = [
        "--assembly-to-ref", os.path.join(root, "asm_to_ref.bam"),
        "--read-to-assembly", os.path.join(root, "read_to_asm.bam"),
        "--ref", os.path.join(root, "ref.fa"),
    ]
    legs = (
        ("host", ["--device", "host"]),
        ("e2e", ["--device", device, "--feed", "native", "--threads", "4"]),
        ("workers2", ["--device", device, "--feed", "native", "--threads",
                      "2", "--local-workers", "2"]),
    )
    for tag, extra in legs:
        rec[tag] = run_cli(base + extra + [
            "--remapped-read-output", os.path.join(out, f"r_{tag}.bam"),
            "--unassembled-read-output", os.path.join(out, f"u_{tag}.bam"),
        ])
        sys.stderr.write(f"[torch_soak_scale n={n_reads}] {tag} {rec[tag]}\n")

    want = digest_bam(os.path.join(out, "r_host.bam"))
    for tag in ("e2e", "workers2"):
        got = digest_bam(os.path.join(out, f"r_{tag}.bam"))
        if got != want:
            raise SystemExit(
                f"EQUALITY FAILED: {tag} ({got[1]} recs, {got[0]:x}) != "
                f"host ({want[1]} recs, {want[0]:x})")
    rec["equality"] = (f"{want[1]} records of both device legs identical to "
                       "the host leg's (order-insensitive)")

    from portello_tpu_torch.tools.merge import merge_bams
    from portello_tpu_torch.tools.sort import sort_bam

    s1, s2 = os.path.join(out, "s1.bam"), os.path.join(out, "s2.bam")
    t0 = time.perf_counter()
    sort_bam(os.path.join(out, "r_e2e.bam"), s1, n_threads=4)
    sort_bam(os.path.join(out, "r_workers2.bam"), s2, n_threads=4)
    rec["sort_wall_s"] = round(time.perf_counter() - t0, 1)
    merged = os.path.join(out, "merged.bam")
    t0 = time.perf_counter()
    merge_bams(merged, [s1, s2], n_threads=4)
    rec["merge_wall_s"] = round(time.perf_counter() - t0, 1)
    _, nm = digest_bam(merged)
    if nm != 2 * want[1]:
        raise SystemExit(f"merge record count {nm} != {2 * want[1]}")
    rec["out_bam_mb"] = os.path.getsize(os.path.join(out, "r_e2e.bam")) // 2**20
    shutil.rmtree(out, ignore_errors=True)
    return rec


def main():
    argv = sys.argv[1:]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, not {device!r}")
    skip_half = "--skip-half" in argv
    argv = [a for a in argv if a != "--skip-half"]
    n = int(argv[0]) if argv else 100_000
    summary = {"full": run_scale(n, 2026, device)}
    if device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        summary["card"] = smi.stdout.strip().splitlines()[0]
    if not skip_half:
        summary["half"] = run_scale(n // 2, 2027, device)
        f, h = summary["full"], summary["half"]
        if f["e2e"]["peak_rss_mb"] and h["e2e"]["peak_rss_mb"]:
            summary["rss_full_over_half"] = round(
                f["e2e"]["peak_rss_mb"] / h["e2e"]["peak_rss_mb"], 2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
