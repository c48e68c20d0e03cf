"""PyTorch port CLI: ``python -m portello_tpu_torch.main --device cpu`` writes
the same records as JAX's ``--device cpu`` and as the exact host path: on the
native feed in resident slot mode (the default) and on table slots
(``PTPU_RESIDENT=0``), under device-shift routing (``PTPU_HOST_SHIFT=0``),
and on the Python feed under both routings; ``--feed auto`` without the
native scanner runs the Python feed; ``--device cuda`` without a GPU exits
non-zero."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.simulate import make_scenario

pytestmark = pytest.mark.skipif(
    native_feed.get_lib() is None,
    reason=f"ptscan unavailable: {native_feed.build_error()}",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(tmp_path, tag, device, *extra):
    return [
        "--assembly-to-ref", str(tmp_path / "asm_to_ref.bam"),
        "--read-to-assembly", str(tmp_path / "read_to_asm.bam"),
        "--remapped-read-output", str(tmp_path / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(tmp_path / f"un_{tag}.bam"),
        "--ref", str(tmp_path / "ref.fa"),
        "--device", device, "--batch-size", "32", *extra,
    ]


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    make_scenario(str(d), rng=np.random.default_rng(21),
                  n_reads_per_contig=40, read_len=300)
    return d


def test_port_cpu_native_equals_jax_and_host(scenario):
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    port_main(_args(scenario, "port", "cpu", "--feed", "native"))
    jax_main(_args(scenario, "jax", "cpu", "--feed", "native"))
    jax_main(_args(scenario, "host", "host"))
    for kind in ("remapped", "un"):
        port = _records(scenario / f"{kind}_port.bam")
        assert port == _records(scenario / f"{kind}_jax.bam"), kind
        assert port == _records(scenario / f"{kind}_host.bam"), kind
    assert len(_records(scenario / "remapped_port.bam")) > 0


@pytest.mark.parametrize("resident", ["1", "0"])
def test_port_slot_modes_equal_jax_and_host(scenario, monkeypatch, resident):
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.pipeline import native_feed as port_feed

    tag = f"mode{resident}"
    jax_main(_args(scenario, f"jax_{tag}", "cpu", "--feed", "native"))
    jax_main(_args(scenario, f"host_{tag}", "host"))
    stats = []
    run = port_feed.scan_and_remap_reads_native
    monkeypatch.setattr(port_feed, "scan_and_remap_reads_native",
                        lambda *a, **k: stats.append(run(*a, **k)) or stats[-1])
    monkeypatch.setenv("PTPU_RESIDENT", resident)
    port_main(_args(scenario, tag, "cpu", "--feed", "native"))
    assert [s["resident"] for s in stats] == [resident == "1"]
    # the packed rows are a quarter of the two byte tables they replace
    per_batch = stats[0]["h2d_bytes_per_batch"]
    assert (per_batch < 500_000) == (resident == "1") and per_batch > 0
    for kind in ("remapped", "un"):
        port = _records(scenario / f"{kind}_{tag}.bam")
        assert port == _records(scenario / f"{kind}_jax_{tag}.bam"), kind
        assert port == _records(scenario / f"{kind}_host_{tag}.bam"), kind
    assert len(_records(scenario / f"remapped_{tag}.bam")) > 0


def _spy_native(monkeypatch):
    """Record the stats of each native-feed run of the port."""
    from portello_tpu_torch.pipeline import native_feed as port_feed

    stats = []
    run = port_feed.scan_and_remap_reads_native
    monkeypatch.setattr(port_feed, "scan_and_remap_reads_native",
                        lambda *a, **k: stats.append(run(*a, **k)) or stats[-1])
    return stats


def _spy_engines(monkeypatch):
    """Record each DeviceEngine the port's CLI builds."""
    from portello_tpu_torch.models import pipeline_model as tpm

    engines = []

    class Spy(tpm.DeviceEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(tpm, "DeviceEngine", Spy)
    return engines


def _assert_same_records(scenario, tag, *others):
    for kind in ("remapped", "un"):
        port = _records(scenario / f"{kind}_{tag}.bam")
        for other in others:
            assert port == _records(scenario / f"{kind}_{other}.bam"), (kind, other)
    assert len(_records(scenario / f"remapped_{tag}.bam")) > 0


@pytest.mark.parametrize("host_shift", ["1", "0"])
def test_port_python_feed_equals_jax_and_host(scenario, monkeypatch, host_shift):
    """--feed python: the port's DeviceEngine under host-shift routing and
    under device-shift routing, where reverse-contig groups run rev_batch."""
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    tag = f"py{host_shift}"
    monkeypatch.setenv("PTPU_HOST_SHIFT", host_shift)
    jax_main(_args(scenario, f"jax_{tag}", "cpu", "--feed", "python"))
    jax_main(_args(scenario, f"host_{tag}", "host"))
    engines = _spy_engines(monkeypatch)
    port_main(_args(scenario, tag, "cpu", "--feed", "python"))
    assert len(engines) == 1
    stats = engines[0].stats
    assert engines[0].host_shift == (host_shift == "1")
    assert stats["device_items"] > 0 and stats["batches"] > 0
    assert (stats["rev_batches"] > 0) == (host_shift == "0")
    _assert_same_records(scenario, tag, f"jax_{tag}", f"host_{tag}")


def test_port_native_device_shift_equals_jax_and_host(scenario, monkeypatch):
    """PTPU_HOST_SHIFT=0 on the native feed: the scanner emits reverse
    batches on table slots, and the port runs rev_batch on them."""
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    monkeypatch.setenv("PTPU_HOST_SHIFT", "0")
    jax_main(_args(scenario, "jax_ds", "cpu", "--feed", "native"))
    jax_main(_args(scenario, "host_ds", "host"))
    stats = _spy_native(monkeypatch)
    port_main(_args(scenario, "ds", "cpu", "--feed", "native"))
    assert [s["resident"] for s in stats] == [False]
    assert stats[0]["rev_batches"] > 0
    assert stats[0]["h2d_bytes_per_rev_batch"] > stats[0]["h2d_bytes_per_batch"]
    _assert_same_records(scenario, "ds", "jax_ds", "host_ds")


def test_resident_with_device_shift_runs_table_slots(scenario, monkeypatch):
    """PTPU_RESIDENT=1 with PTPU_HOST_SHIFT=0 falls back to table slots with
    the same records, as in the JAX package."""
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    monkeypatch.setenv("PTPU_RESIDENT", "1")
    monkeypatch.setenv("PTPU_HOST_SHIFT", "0")
    jax_main(_args(scenario, "jax_rds", "cpu", "--feed", "native"))
    jax_main(_args(scenario, "host_rds", "host"))
    stats = _spy_native(monkeypatch)
    port_main(_args(scenario, "rds", "cpu", "--feed", "native"))
    assert [s["resident"] for s in stats] == [False]
    assert stats[0]["rev_batches"] > 0
    _assert_same_records(scenario, "rds", "jax_rds", "host_rds")


def test_feed_auto_without_native_scanner_runs_python_feed(scenario, monkeypatch):
    """--feed auto runs the Python feed when ptscan cannot be built, as the
    JAX package does; it still runs the port's steps on the device."""
    from portello_tpu.main import main as jax_main
    from portello_tpu.pipeline import native_feed as jax_feed
    from portello_tpu_torch.main import main as port_main

    jax_main(_args(scenario, "host_auto", "host"))
    monkeypatch.setattr(jax_feed, "get_lib", lambda: None)
    engines = _spy_engines(monkeypatch)
    native = _spy_native(monkeypatch)
    port_main(_args(scenario, "auto", "cpu", "--feed", "auto"))
    assert len(engines) == 1 and native == []
    assert engines[0].stats["device_items"] > 0
    assert engines[0].device == torch.device("cpu")
    _assert_same_records(scenario, "auto", "host_auto")


def test_feed_native_without_native_scanner_exits(scenario, monkeypatch):
    from portello_tpu.pipeline import native_feed as jax_feed
    from portello_tpu_torch.main import main as port_main

    monkeypatch.setattr(jax_feed, "get_lib", lambda: None)
    with pytest.raises(SystemExit) as e:
        port_main(_args(scenario, "nolib", "cpu", "--feed", "native"))
    assert "--feed native needs the native scanner" in str(e.value.code)
    assert not (scenario / "remapped_nolib.bam").exists()


def test_bad_resident_switch_is_refused(scenario, monkeypatch, capsys):
    from portello_tpu_torch.main import main as port_main

    monkeypatch.setenv("PTPU_RESIDENT", "yes")
    with pytest.raises(SystemExit) as e:
        port_main(_args(scenario, "badres", "cpu", "--feed", "native"))
    assert e.value.code == 2
    assert "PTPU_RESIDENT" in capsys.readouterr().err


def test_port_host_device_equals_host_path(scenario):
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    port_main(_args(scenario, "port_host", "host"))
    jax_main(_args(scenario, "host2", "host"))
    assert _records(scenario / "remapped_port_host.bam") == _records(
        scenario / "remapped_host2.bam"
    )


def test_port_streams_cram_input(scenario, tmp_path):
    """A CRAM read input streams into the native scanner through the shared
    feeder thread: the same records as JAX's native feed on that CRAM, and
    the same remapped records as the BAM (the CRAM round trip rewrites the
    MAPQ of unmapped pass-through records)."""
    from portello_tpu.io.bam import BamReader
    from portello_tpu.io.cram import CramWriter
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    cram = tmp_path / "read_to_asm.cram"
    with BamReader(str(scenario / "read_to_asm.bam")) as r:
        with CramWriter(str(cram), r.header) as w:
            for rec in r:
                w.write(rec)

    def cram_args(tag):
        args = _args(scenario, tag, "cpu", "--feed", "native")
        args[args.index("--read-to-assembly") + 1] = str(cram)
        return args

    port_main(cram_args("cram"))
    jax_main(cram_args("jax_cram"))
    port_main(_args(scenario, "bam", "cpu", "--feed", "native"))
    for kind in ("remapped", "un"):
        assert _records(scenario / f"{kind}_cram.bam") == _records(
            scenario / f"{kind}_jax_cram.bam"
        ), kind
    assert _records(scenario / "remapped_cram.bam") == _records(
        scenario / "remapped_bam.bam"
    )


def test_device_cuda_without_gpu_exits_nonzero(scenario):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-m", "portello_tpu_torch.main",
         *_args(scenario, "cuda", "cuda")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not (scenario / "remapped_cuda.bam").exists()


@pytest.mark.parametrize(
    "extra,message",
    [
        (("--profile", "prof"), "--profile is not yet ported"),
        (("--local-workers", "2"), "--local-workers is not yet ported"),
    ],
)
def test_unported_options_are_refused(scenario, extra, message):
    from portello_tpu_torch.main import main as port_main

    with pytest.raises(SystemExit) as e:
        port_main(_args(scenario, "refused", "cpu", *extra))
    assert message in str(e.value.code)


def test_device_choices():
    from portello_tpu_torch.main import build_parser

    p = build_parser()
    base = ["--assembly-to-ref", "a", "--read-to-assembly", "b",
            "--remapped-read-output", "c", "--unassembled-read-output", "d",
            "--ref", "e"]
    assert p.parse_args(base).device == "cuda"
    assert p.parse_args(base + ["--device", "host"]).device == "host"
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--device", "tpu"])
