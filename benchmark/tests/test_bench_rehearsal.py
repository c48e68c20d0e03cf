"""The harness end to end on the CPU at a tiny size, with the kernels'
plain versions: set-up, the window's calls, the reference comparison and
the last line's keys; then the same with the timed path broken underneath,
where ``correct`` has to come out false."""

import json

import numpy as np
import pytest

from benchmark import run
from benchmark.tests import tiny


def _run(tmp_path, cell, trace=False, seconds=0.1, seed=2**31 + 5, reads=240):
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        chips_checked=False, bench_spec=tiny.spec(cell, reads),
                        cache=str(tmp_path / "inputs"), work=str(tmp_path / "work"))


@pytest.mark.parametrize("cell", tiny.cells() + tiny.later())
def test_rehearsal(tmp_path, cell):
    r = _run(tmp_path, cell)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in tiny.bench()["end_to_end"]}
    assert r["metrics"]["lifted_reads_per_s"]["value"] > 0
    assert {k: v["limit"] for k, v in r["checks"].items()} == run.LIMITS
    json.dumps(r)


def test_rehearsal_traced(tmp_path):
    r = _run(tmp_path, "revio.devshift", trace=True)
    assert r["correct"], r["checks"]
    per_layer = {m["name"]: m for m in tiny.bench()["per_layer"]}
    # the counters and the program's spans are read on the CPU too; the
    # device metrics stay out of a run without a card
    got = set(r["metrics"])
    assert got <= set(per_layer)
    assert {"call.capture_s", "feed.producer_ms_per_kread", "spill.host_item_share",
            "dispatch.wait_share", "dispatch.h2d_kib_per_read"} <= got
    assert not got & {"step.device_ms_per_batch", "kernels.hand_roofline",
                      "device.idle_share"}
    for name, v in r["metrics"].items():
        assert v["unit"] == per_layer[name]["unit"]
    assert list(r)[-1] == "checks"


def _half_batch(host):
    """The step's outputs with half of the batch's rows (every other one, so
    a partly filled batch loses items too) never computed."""
    for v in host.values():
        v[1::2] = 0
    return host


def _altered(host):
    """Every lifted position moved by one base where the step produces it."""
    host["ref2_pos"] += 1
    return host


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered"])
@pytest.mark.parametrize("cell", ["revio.hostshift", "revio.devshift"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault, cell):
    from portello_tpu_torch.parallel import mesh

    wait = mesh.Handle.wait
    monkeypatch.setattr(mesh.Handle, "wait", lambda self: fault(
        {k: np.array(v) for k, v in wait(self).items()}))
    r = _run(tmp_path, cell)
    assert not r["correct"]
    assert r["checks"]["reads_differing"]["value"] > 0
