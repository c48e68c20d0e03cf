"""The spill path end to end on the CPU: ``python -m portello_tpu_torch.main
--device cpu`` writes the sorted records of the JAX package's ``--device
cpu`` and ``--device host`` on the fallback reads of
``testutil/spill.build_inputs`` (a read past every bucket, a saturated shift
window, spill-bucket reads), on a small WGS-shaped scenario whose batches
fill all three buckets, and under ``--target-region`` on BAM and CRAM 3.1
input; and ``testutil/spill.build_scenario`` writes the records of
``scripts/soak_scale.build_scenario`` for the same seed."""

import importlib.util
import os

import numpy as np
import pytest

from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu_torch.testutil import spill

pytestmark = pytest.mark.skipif(
    native_feed.get_lib() is None,
    reason=f"ptscan unavailable: {native_feed.build_error()}",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = ("asm_to_ref.bam", "read_to_asm.bam", "ref.fa")


def _args(d, tag, device, *extra, inputs=INPUTS):
    return [
        "--assembly-to-ref", os.path.join(d, inputs[0]),
        "--read-to-assembly", os.path.join(d, inputs[1]),
        "--remapped-read-output", os.path.join(d, f"remapped_{tag}.bam"),
        "--unassembled-read-output", os.path.join(d, f"un_{tag}.bam"),
        "--ref", os.path.join(d, inputs[2]),
        "--device", device, "--batch-size", "8", *extra,
    ]


def _records(d, tag, cram=False):
    return {kind: spill.sam_records(os.path.join(d, f"{kind}_{tag}.bam"),
                                    zero_unmapped_mapq=cram and kind == "un",
                                    collapse_eqx=cram)
            for kind in ("remapped", "un")}


def _port_run(monkeypatch, *args):
    """The port's CLI on the CPU; returns its native feed's stats."""
    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.pipeline import native_feed as port_feed

    stats = []
    run = port_feed.scan_and_remap_reads_native
    monkeypatch.setattr(port_feed, "scan_and_remap_reads_native",
                        lambda *a, **k: stats.append(run(*a, **k)) or stats[-1])
    port_main(list(args))
    assert len(stats) == 1
    return stats[0]


def _jax_refs(d, inputs=INPUTS, extra=()):
    """The JAX package's --device cpu and --device host records."""
    from portello_tpu.main import main as jax_main

    jax_main(_args(d, "jax_cpu", "cpu", *extra, inputs=inputs))
    jax_main(_args(d, "jax_host", "host", *extra, inputs=inputs))
    want = _records(d, "jax_host")
    assert _records(d, "jax_cpu") == want
    assert len(want["remapped"]) > 0
    return want


@pytest.mark.parametrize("host_shift", ["1", "0"])
def test_fallback_reads_equal_jax(tmp_path, monkeypatch, host_shift):
    d = str(tmp_path)
    inputs = tuple(os.path.basename(p) for p in spill.build_inputs(d))
    monkeypatch.setenv("PTPU_HOST_SHIFT", host_shift)
    want = _jax_refs(d, inputs)
    stats = _port_run(monkeypatch, *_args(d, "port", "cpu", inputs=inputs))
    assert _records(d, "port") == want
    # all_host passes every bucket; the saturated window is flagged only
    # where the reverse step shifts on the device
    assert stats["host_items"] >= 1
    assert stats["fallback_items"] >= (1 if host_shift == "0" else 0)
    assert all(stats["batches_per_bucket"]), stats["batches_per_bucket"]


def test_wgs_shaped_scenario_fills_every_bucket(tmp_path, monkeypatch):
    d = str(tmp_path)
    assert spill.build_scenario(d, 40, np.random.default_rng(2026)) == 40
    want = _jax_refs(d)
    stats = _port_run(monkeypatch, *_args(d, "port", "cpu"))
    assert _records(d, "port") == want
    per_bucket = stats["batches_per_bucket"]
    assert len(per_bucket) == 3 and all(per_bucket), per_bucket
    assert stats["resident"] and stats["device_items"] == 40


def test_target_region_on_bam_and_cram(tmp_path, monkeypatch):
    d = str(tmp_path)
    make_scenario(d, rng=np.random.default_rng(21), n_reads_per_contig=40,
                  read_len=300)
    cram = os.path.basename(
        spill.write_crams(os.path.join(d, INPUTS[1]), ("31",))["31"])
    region = ("--target-region", "chr1:1-6000")
    want = _jax_refs(d, extra=region)
    _port_run(monkeypatch, *_args(d, "port_bam", "cpu", *region))
    assert _records(d, "port_bam") == want
    _port_run(monkeypatch, *_args(d, "port_cram", "cpu", *region,
                                  inputs=(INPUTS[0], cram, INPUTS[2])))
    assert _records(d, "port_cram", cram=True) == _records(d, "jax_host",
                                                           cram=True)
    # the region keeps some of the reads, not all
    from portello_tpu.main import main as jax_main

    jax_main(_args(d, "jax_all", "host"))
    n_all = len(_records(d, "jax_all")["remapped"])
    assert 0 < len(want["remapped"]) < n_all


def test_builder_equals_soak_scale(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "soak_scale", os.path.join(REPO, "scripts", "soak_scale.py"))
    soak_scale = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak_scale)
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    n = spill.build_scenario(port, 30, np.random.default_rng(5))
    assert n == soak_scale.build_scenario(jax, 30, np.random.default_rng(5))
    with open(os.path.join(port, "ref.fa"), "rb") as a, \
            open(os.path.join(jax, "ref.fa"), "rb") as b:
        assert a.read() == b.read()
    for name in ("asm_to_ref.bam", "read_to_asm.bam"):
        assert spill.sam_records(os.path.join(port, name)) == \
            spill.sam_records(os.path.join(jax, name)), name
        assert os.path.exists(os.path.join(port, name + ".bai"))


@pytest.mark.parametrize("seed, kind", [(707532116, "wgs-shaped"),
                                        (1793244058, "make_scenario"),
                                        (4, "fallback reads")])
def test_fuzz_soak_scenario_round(seed, kind):
    """``scripts/torch_fuzz_soak.py --scenario`` on pinned seeds: a WGS-shaped
    scenario whose one flagged item comes back through the host finisher, a
    ``make_scenario`` one on table slots, and the fallback reads under
    device-shift routing (a flagged item); each CLI run on the native feed
    equals the host path."""
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_soak", os.path.join(REPO, "scripts", "torch_fuzz_soak.py"))
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    drew = fuzz.scenario_round(seed, "cpu")
    assert drew.startswith(kind), drew
    if kind != "make_scenario":
        assert "fallback items 1" in drew, drew
