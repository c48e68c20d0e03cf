#!/usr/bin/env python3
"""Compare the Python feed (``--feed python --device cuda``) of two trees
of this repository on one card, in turns: other, this, this, other.

    python3 scripts/torch_pyfeed_ab.py OTHER_TREE [--out FILE]
        [--scenarios phase5,wgs3000,reads20000] [--device cuda]

OTHER_TREE is another checkout (say, the parent commit unpacked with
``git archive`` into a directory that .gitignore lists).  The scenarios
build once, in parallel, under this tree's ``.bench_cache/pyfeed_<name>``:

- ``phase5``: ``chip_smoke.py`` phase 5's scenario (``make_scenario``,
  seed 99, 400 reads per contig of 18 kb: 1,601 reads);
- ``wgs3000``: phase 5b's WGS-shaped scenario (``spill.build_scenario``,
  3,000 reads of 2-60 kb, seed 2026);
- ``reads20000``: ``make_scenario``, seed 99, 5,000 reads per contig of
  18 kb (20,001 reads);
- ``tiny``: ``make_scenario``, seed 99, 40 reads per contig of 300 bases,
  to rehearse the script on the CPU with ``--device cpu``.

Each turn runs the tree's CLI in a fresh process (``--child``), in-process
there, with the engine's methods wrapped by timers, and prints one JSON
line: the CLI's wall seconds; the seconds in ``_run_group`` (build, copy
and run the groups; where the tree has them, its parts ``group_inputs``,
the numpy build, and ``group_step``, the staging copy, replay and copy
back), in ``_prep_item`` (the per-item host prep), in
``_finish_item`` (the per-item host finish) and in ``flush`` (the groups,
the finish and the record writes), and the collector's pauses (``gc_s``,
``gc_collections`` per generation); the engine's batches and compiled-step
stats (graphs, replays, warm-up and capture seconds; absent where the tree
has none); the peak device memory allocated and reserved; and a digest of
the sorted output records, which must be the same in every turn of a
scenario.  The output BAMs are written to a temporary directory and
removed; each turn's log goes beside ``--out``.  A warm-up run of each tree
on the first scenario builds its kernels first and is left out.  Writes
every turn to ``--out`` (JSON; ``.bench_cache/pyfeed_ab.json`` by default)
and exits non-zero if a turn failed or the records differ.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _build(name: str, d: str) -> None:
    """Worker job: scenario ``name`` in ``d`` (built in ``d``.tmp, then
    renamed)."""
    import shutil

    import numpy as np

    sys.path.insert(0, ROOT)
    from portello_tpu_torch.testutil.simulate import make_scenario
    from portello_tpu_torch.testutil.spill import build_scenario

    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    if name == "wgs3000":
        build_scenario(tmp, 3000, np.random.default_rng(2026))
    else:
        per_contig, read_len, chrom_len = {
            "phase5": (400, 18000, 200000),
            "reads20000": (5000, 18000, 200000),
            "tiny": (40, 300, 20000)}[name]
        make_scenario(tmp, rng=np.random.default_rng(99),
                      n_reads_per_contig=per_contig, read_len=read_len,
                      chrom_len=chrom_len)
    os.rename(tmp, d)


def child(tree: str, scenario: str, device: str) -> dict:
    """One CLI run of ``tree``'s port on ``scenario``; the turn's fields."""
    sys.path.insert(0, tree)
    import torch

    from portello_tpu_torch.main import main
    from portello_tpu_torch.models import pipeline_model as pm
    from portello_tpu_torch.testutil.spill import sam_records

    timed = {}
    engines = []
    init = pm.DeviceEngine.__init__

    def timer(owner, name):
        function = getattr(owner, name)
        timed[name] = [0.0, 0]

        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return function(*a, **k)
            finally:
                timed[name][0] += time.perf_counter() - t0
                timed[name][1] += 1

        setattr(owner, name, run)

    for name in ("_run_group", "_prep_item", "_finish_item", "flush"):
        timer(pm.DeviceEngine, name)
    # the parts of a compiled group, where the tree has them
    for name in ("group_inputs", "group_step"):
        if hasattr(pm, name):
            timer(pm, name)

    def spied_init(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    pm.DeviceEngine.__init__ = spied_init
    pauses = {"s": 0.0, "t0": 0.0, "n": [0, 0, 0]}

    def on_gc(phase, info):
        if phase == "start":
            pauses["t0"] = time.perf_counter()
        else:
            pauses["s"] += time.perf_counter() - pauses["t0"]
            pauses["n"][info["generation"]] += 1

    gc.callbacks.append(on_gc)
    bams = tempfile.mkdtemp(prefix="pyfeed_ab_")
    paths = {k: os.path.join(bams, f"{k}.bam") for k in ("remapped", "un")}
    args = [
        "--assembly-to-ref", os.path.join(scenario, "asm_to_ref.bam"),
        "--read-to-assembly", os.path.join(scenario, "read_to_asm.bam"),
        "--remapped-read-output", paths["remapped"],
        "--unassembled-read-output", paths["un"],
        "--ref", os.path.join(scenario, "ref.fa"),
        "--device", device, "--feed", "python",
        "--threads", str(os.cpu_count() or 1),
    ]
    try:
        t0 = time.perf_counter()
        main(args)
        wall = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
        if len(engines) != 1:
            raise RuntimeError(f"{len(engines)} engines ran")
        stats = engines[0].stats
        digest = hashlib.sha256()
        for k in ("remapped", "un"):
            for line in sam_records(paths[k]):
                digest.update(line.encode() + b"\n")
    finally:
        shutil.rmtree(bams, ignore_errors=True)
    return {
        "wall_s": wall,
        "run_group_s": timed["_run_group"][0],
        "run_group_calls": timed["_run_group"][1],
        "prep_s": timed["_prep_item"][0],
        "finish_s": timed["_finish_item"][0],
        "flush_s": timed["flush"][0],
        "group_inputs_s": timed.get("group_inputs", [None])[0],
        "group_step_s": timed.get("group_step", [None])[0],
        "gc_s": pauses["s"],
        "gc_collections": pauses["n"],
        **{k: stats.get(k) for k in (
            "device_items", "host_items", "batches", "rev_batches",
            "compiled_steps", "replays", "t_capture", "groups")},
        "peak_allocated_mib": (torch.cuda.max_memory_allocated() / 2**20
                               if device == "cuda" else None),
        "peak_reserved_mib": (torch.cuda.max_memory_reserved() / 2**20
                              if device == "cuda" else None),
        "records_sha256": digest.hexdigest(),
    }


def _turn(tree: str, scenario: str, tag: str, out: str, device: str) -> dict:
    """A ``--child`` process of ``tree`` on ``scenario``; its fields.  Its
    log goes to ``out/tag.err``."""
    os.makedirs(out, exist_ok=True)
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         scenario, device],
        capture_output=True, text=True, timeout=1800)
    with open(os.path.join(out, f"{tag}.err"), "w") as f:
        f.write(p.stderr)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("TURN ")]
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"{tag}: rc {p.returncode}\n{p.stderr[-3000:]}")
    fields = json.loads(lines[-1][5:])
    fields["log"] = [ln.split("] ", 1)[-1] for ln in p.stderr.splitlines()
                     if "Compiled steps" in ln or "Python feed" in ln
                     or "peak device memory" in ln]
    return fields


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("--out", default=None)
    ap.add_argument("--scenarios", default="phase5,wgs3000,reads20000")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import multiprocessing as mp

    smi = "no card (--device cpu)"
    if a.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    trees = {"other": os.path.abspath(a.other), "this": ROOT}
    names = a.scenarios.split(",")
    cache = os.path.join(ROOT, ".bench_cache")
    dirs = {n: os.path.join(cache, f"pyfeed_{n}") for n in names}
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(len(names)) as pool:
        jobs = [pool.apply_async(_build, (n, d)) for n, d in dirs.items()
                if not os.path.isdir(d)]
        for j in jobs:
            j.get()
    print(f"scenarios ready in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.abspath(a.out or os.path.join(cache, "pyfeed_ab.json"))
    work = os.path.dirname(out)
    os.makedirs(work, exist_ok=True)
    results = {"card": smi.strip(), "turns": []}
    ok = True
    for t in ("other", "this"):
        f = _turn(trees[t], dirs[names[0]], f"warmup_{t}",
                  os.path.join(work, "pyfeed_runs"), a.device)
        print(f"warm-up {t}: wall {f['wall_s']:.2f} s", flush=True)
    i = 0
    for name in names:
        digests = set()
        for t in ("other", "this", "this", "other"):
            i += 1
            f = _turn(trees[t], dirs[name], f"{i}_{name}_{t}",
                      os.path.join(work, "pyfeed_runs"), a.device)
            f.update(turn=i, scenario=name, tree=t)
            results["turns"].append(f)
            digests.add(f["records_sha256"])
            print("TURN " + json.dumps({k: v for k, v in f.items()
                                        if k != "log"}), flush=True)
            for ln in f["log"]:
                print(f"    {ln}", flush=True)
        if len(digests) != 1:
            print(f"{name}: the trees' records differ", flush=True)
            ok = False
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        fields = child(*sys.argv[2:])
        print("TURN " + json.dumps(fields), flush=True)
        sys.exit(0)
    sys.exit(main())
