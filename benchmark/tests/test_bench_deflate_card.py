"""The harness's reader of the share of BGZF blocks deflated on the card, on
a traced CPU rehearsal: it reports under its unit from ``BENCHMARK.json`` and
reads 0.0, since without a card every block is deflated on the host."""

from benchmark.tests import tiny
from benchmark.tests.test_bench_rehearsal import _run

NAME = "feed.deflate_card_share"


def test_rehearsal_traced_reads_no_card_share(tmp_path):
    r = _run(tmp_path, "revio.hostshift", trace=True)
    assert r["correct"], r["checks"]
    unit = next(m["unit"] for m in tiny.bench()["per_layer"] if m["name"] == NAME)
    assert r["metrics"][NAME]["unit"] == unit
    assert r["metrics"][NAME]["value"] == 0.0
