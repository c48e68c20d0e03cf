#!/usr/bin/env python3
"""Time the port's sharded step (``parallel/mesh.py``) on the card or cards.

    python3 scripts/torch_mesh_step.py [--passes N] [--out FILE]

Each step kind of the primary bucket (the table, resident and reverse
steps) runs at B=512 HiFi items (18 kb reads) through
``parallel/mesh.ShardedStep``, as the native feed dispatches a batch: the
arrays into pinned staging, one CUDA graph replay per shard, the outputs
back into pinned host buffers.  Meshes: one GPU, two shards on the first
GPU, and every visible GPU where there are several.  On each mesh the
first batch's fields must equal the eager step's on one GPU (tolerance 0);
then, in interleaved passes, the ms per batch of

- ``lone``: one batch from host arrays to host outputs, waited on
  (median of 20);
- ``stream``: back-to-back batches with two in flight, as the native feed
  keeps them (each submit followed by the wait on the batch before it),
  for 1 s of host time; elapsed over the batches.

Prints the card's name and power limit, one line per mesh and step, and a
JSON line with every pass (``--out`` writes it to a file too).  Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GENOME_BYTES = 1 << 30
LONE_CALLS = 20
STREAM_SECONDS = 1.0


def _lone_ms(run, arrays) -> float:
    ts = []
    for _ in range(LONE_CALLS):
        t0 = time.perf_counter()
        run.submit(*arrays).wait()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _stream_ms(run, arrays) -> float:
    prev = run.submit(*arrays)
    n = 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < STREAM_SECONDS:
        handle = run.submit(*arrays)
        prev.wait()
        prev = handle
        n += 1
    prev.wait()
    return (time.perf_counter() - t0) * 1e3 / (n + 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_step: no CUDA device", file=sys.stderr)
        return 1
    from portello_tpu_torch.graft_entry import require_equal
    from portello_tpu_torch.models.compiled import StepCache, step_function
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        bucket_kwargs,
    )
    from portello_tpu_torch.parallel.mesh import (
        local_devices,
        replicate,
        sharded_step,
    )
    from portello_tpu_torch.testutil.batchgen import (
        make_item_arrays,
        resident_from_table,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gpus = local_devices("cuda")
    meshes = {"1 GPU": gpus[:1], "2 shards on 1 GPU": gpus[:1] * 2}
    if len(gpus) > 1:
        meshes[f"{len(gpus)} GPUs"] = gpus
    bcfg = DEFAULT_BUCKETS[0]
    kw = bucket_kwargs(bcfg)
    rng = np.random.default_rng(20261017)
    rev = make_item_arrays(rng, 512, bcfg, read_len=18000, rev=True)
    table = tuple(rev[:4]) + tuple(rev[6:])
    g_sb, g_off, packed, genome_np = resident_from_table(table, GENOME_BYTES,
                                                         rng)
    cases = {"table": ("fwd", table),
             "resident": ("fwd_resident",
                          tuple(table[:7]) + (g_sb, g_off, table[8], packed)),
             "rev": ("rev", rev)}
    replicas = {name: replicate(mesh, genome_np) for name, mesh in meshes.items()}
    runs = {}
    for mode, (kind, arrays) in cases.items():
        genome = replicas["1 GPU"][0] if kind == "fwd_resident" else None
        extra = () if genome is None else (genome,)
        want = step_function(kind, kw)(
            *(torch.from_numpy(a).to(gpus[0]) for a in arrays), *extra)
        for name, mesh in meshes.items():
            run = sharded_step(StepCache(), kind, mesh, 512, kw,
                               replicas[name] if genome is not None else None)
            require_equal(run(*arrays), want, f"{mode} on {name}")
            runs[(mode, name)] = run
    print("every mesh's first batch == the eager step on one GPU", flush=True)
    passes = {f"{mode} | {name}": {"lone": [], "stream": []}
              for mode, name in runs}
    for _ in range(args.passes):
        for (mode, name), run in runs.items():
            arrays = cases[mode][1]
            p = passes[f"{mode} | {name}"]
            p["lone"].append(round(_lone_ms(run, arrays), 4))
            p["stream"].append(round(_stream_ms(run, arrays), 4))
    for key, p in passes.items():
        print(f"{key}: ms per batch, lone {statistics.median(p['lone']):.3f} "
              f"(passes {p['lone']}), two in flight "
              f"{statistics.median(p['stream']):.3f} (passes {p['stream']}) "
              f"({smi.splitlines()[0]})", flush=True)
    line = {"device": torch.cuda.get_device_name(0), "gpus": len(gpus),
            "power_limit": smi.splitlines()[0].rsplit(",", 1)[-1].strip(),
            "batch": 512, "passes": passes}
    print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
