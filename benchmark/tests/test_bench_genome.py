"""The harness's readers of the resident genome's build and upload, on a
traced CPU rehearsal of the whole-genome cell: each reports under its unit
from ``BENCHMARK.json``; and on stats without the program's ``genome_bytes``
(a program that lacks the counter) or with none uploaded (table slots),
each reads nothing."""

import pytest

from benchmark import run
from benchmark.tests import tiny
from benchmark.tests.test_bench_rehearsal import _run

NAMES = ("genome.build_ms_per_gb", "genome.upload_link_share")


def _entries():
    return [m for m in tiny.bench()["per_layer"] if m["name"] in NAMES]


def test_rehearsal_traced_reads_the_genome_metrics(tmp_path):
    r = _run(tmp_path, "revio.wholegenome", trace=True)
    assert r["correct"], r["checks"]
    for m in _entries():
        assert r["metrics"][m["name"]]["unit"] == m["unit"], m["name"]
        assert r["metrics"][m["name"]]["value"] > 0.0, m["name"]


def _spans():
    return [["startup.genome_build", 0, "main", 0, 2_000_000],
            ["startup.genome_upload", 0, "main", 2_000_000, 2_500_000]]


@pytest.mark.parametrize("stats", [{"spans": _spans()},
                                   {"spans": _spans(), "genome_bytes": 0}],
                         ids=["no_counter", "table_slots"])
def test_no_genome_reads_nothing(stats):
    assert run.read_metrics(_entries(), {"calls": [{"stats": stats}]}) == {}


def test_genome_metrics_arithmetic():
    stats = {"spans": _spans(), "genome_bytes": 3_200_000_000}
    got = run.read_metrics(_entries(), {"calls": [{"stats": stats}] * 2})
    # 2 ms over 3.2 GB; 3.2 GB in 0.5 ms over 64 GB/s
    assert got["genome.build_ms_per_gb"]["value"] == pytest.approx(0.625)
    assert got["genome.upload_link_share"]["value"] == pytest.approx(100.0)
