"""Cells of ``BENCHMARK.json`` cut to a size a CPU test can hold: the
configuration's chromosomes and contig layout scaled down by ``scale``, the
mix's read count set by the test; every rate, length distribution and
program switch as the cell has it."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name: str, scale: int = 100) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        c = copy.deepcopy(json.load(f))
    c["chromosomes"] = [[n, ln // scale] for n, ln in c["chromosomes"]]
    for ct in c["contigs"]:
        ct["parts"] = [[a // scale, b // scale, s] for a, b, s in ct["parts"]]
    return c


def mix(name: str, reads: int) -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as f:
        m = json.load(f)
    m["reads"] = reads
    return m


# Cells that ``BENCHMARK.json`` leaves out for now, with configuration and
# mix files that the benchmark keeps: the harness still has to run them, so
# that a later change can add the cell back as an entry alone.
LATER = [
    {"name": "revio.devshift", "config": "hg002-revio-grch38-devshift", "traffic": "revio",
     "chips": 1, "why": "the revio reads on device-shift routing (PTPU_HOST_SHIFT=0)"},
]


def spec(cell_name: str, reads: int = 300, scale: int = 100):
    """(bench, cell, config, mix) as ``run.run_cell`` takes them; a cell of
    ``LATER`` joins a copy of the benchmark, with every per-layer metric."""
    b = bench()
    cell = next((w for w in b["workloads"] if w["name"] == cell_name), None)
    if cell is None:
        cell = next(w for w in LATER if w["name"] == cell_name)
        b["workloads"].append(cell)
        for m in b["per_layer"]:
            m.setdefault("workloads", []).append(cell_name)
    return b, cell, config(cell["config"], scale), mix(cell["traffic"], reads)


def cells() -> list[str]:
    return [w["name"] for w in bench()["workloads"]]


def later() -> list[str]:
    return [w["name"] for w in LATER]
