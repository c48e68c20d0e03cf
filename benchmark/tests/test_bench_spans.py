"""The harness's readers of the program's spans and wait counters, on a
traced CPU rehearsal: each reports under its unit from ``BENCHMARK.json``,
as it does on the card."""

from benchmark.tests import tiny
from benchmark.tests.test_bench_rehearsal import _run

SPAN_AND_WAIT_METRICS = (
    "call.startup_s", "call.finish_s", "feed.next_batch_wait_share",
    "feed.inflate_wait_ms_per_kread", "feed.finisher_wait_ms_per_kread",
    "feed.deflate_wait_ms_per_kread", "feed.deflate_cpu_ms_per_kread",
    "spill.host_lift_ms_per_kread")


def test_rehearsal_traced_reads_the_spans_and_waits(tmp_path):
    r = _run(tmp_path, "revio.hostshift", trace=True)
    assert r["correct"], r["checks"]
    per_layer = {m["name"]: m for m in tiny.bench()["per_layer"]}
    for name in SPAN_AND_WAIT_METRICS:
        assert r["metrics"][name]["unit"] == per_layer[name]["unit"], name
        assert r["metrics"][name]["value"] >= 0.0, name
    assert r["metrics"]["call.startup_s"]["value"] > 0.0
    assert r["metrics"]["call.finish_s"]["value"] > 0.0
