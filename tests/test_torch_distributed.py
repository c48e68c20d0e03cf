"""Scale-out of the PyTorch port on the CPU.

The port's shard plans and shard names equal the JAX package's; two-host
shards (independent runs, and runs joined by a gloo rendezvous through
``--coordinator``) and ``--local-workers`` merge to the port's single run and
to the JAX package's; ``--profile`` writes a trace.  Every record comparison
is exact, on sorted SAM records.  CLIs that fork workers run in a fresh
interpreter with a timeout: a forked child of a process that has run torch
CPU ops is not what the test means to exercise."""

import json
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from portello_tpu.parallel import distributed as jax_distributed
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu.tools.merge import merge_bams
from portello_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _env(**extra):
    return dict(os.environ, **extra,
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _args(d, tag, device, *extra, reads="read_to_asm.bam"):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / reads),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"),
        "--device", device, "--batch-size", "16", *extra,
    ]


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def _assert_same(d, tag, *others):
    for kind in ("remapped", "un"):
        got = _records(d / f"{kind}_{tag}.bam")
        for other in others:
            assert got == _records(d / f"{kind}_{other}.bam"), (kind, other)
    assert len(_records(d / f"remapped_{tag}.bam")) > 0


def _merge_shards(d, tag, n=2):
    """Merge the ``n`` shards of each output of run ``tag`` into
    ``{kind}_{tag}_merged.bam``; returns the shards' record counts."""
    counts = {}
    for kind in ("remapped", "un"):
        shards = [
            distributed.shard_output_path(str(d / f"{kind}_{tag}.bam"), h, n)
            for h in range(n)
        ]
        counts[kind] = [len(_records(s)) for s in shards]
        merge_bams(str(d / f"{kind}_{tag}_merged.bam"), shards)
    return counts


def _needs_ptscan():
    from portello_tpu.pipeline import native_feed

    if native_feed.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {native_feed.build_error()}")


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """A small scenario and the JAX package's single host-path run on it."""
    from portello_tpu.main import main as jax_main

    d = tmp_path_factory.mktemp("torch_dist")
    make_scenario(str(d), rng=np.random.default_rng(37),
                  n_reads_per_contig=30, read_len=300)
    jax_main(_args(d, "jax", "host"))
    return d


@pytest.fixture
def log_lines():
    """The messages the ``portello-tpu`` logger emits during the test."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("portello-tpu")
    handler = Keep()
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


@pytest.mark.parametrize(
    "n_contigs,n_hosts,seed",
    [(5, 2, 0), (12, 3, 1), (40, 4, 2), (3, 8, 3), (64, 5, 4)],
)
def test_plan_host_shards_equals_jax(n_contigs, n_hosts, seed):
    """Seeded lengths from a narrow range, so many contigs tie; the last
    case has more hosts than contigs.  Exact equality of the owned lists."""
    lengths = np.random.default_rng(seed).integers(1, 12, n_contigs).tolist()
    owned = []
    for h in range(n_hosts):
        port = distributed.plan_host_shards(lengths, n_hosts, h)
        want = jax_distributed.plan_host_shards(lengths, n_hosts, h)
        assert port.contig_indices == want.contig_indices
        assert (port.host_id, port.num_hosts) == (h, n_hosts)
        assert all(port.owns(i) for i in port.contig_indices)
        owned += port.contig_indices
    assert sorted(owned) == list(range(n_contigs))


@pytest.mark.parametrize(
    "path,host_id,num_hosts,want",
    [
        ("out.bam", 1, 4, "out.shard01of04.bam"),
        ("out", 0, 2, "out.shard00of02"),
        ("-", 0, 2, "-"),
        ("x/y.bam", 3, 8, "x/y.shard03of08.bam"),
    ],
)
def test_shard_output_path_equals_jax(path, host_id, num_hosts, want):
    got = distributed.shard_output_path(path, host_id, num_hosts)
    assert got == jax_distributed.shard_output_path(path, host_id, num_hosts)
    assert got == want


@pytest.mark.parametrize(
    "device,feed",
    [("host", None), ("cpu", "native"), ("cpu", "python")],
)
def test_two_host_shards_merge_to_single(scenario, device, feed):
    """Each host lifts only its contigs into its own shard, and only host 0
    writes the unassembled reads; the merged shards equal the single run.
    (``--device host`` once ignored the shard plan and wrote every read to
    the unsharded path.)"""
    from portello_tpu_torch.main import main as port_main

    if feed == "native":
        _needs_ptscan()
    extra = ("--feed", feed) if feed else ()
    tag = f"two_{device}_{feed}"
    port_main(_args(scenario, f"{tag}_single", device, *extra))
    for h in range(2):
        port_main(_args(scenario, tag, device, *extra,
                        "--num-hosts", "2", "--host-id", str(h)))
    assert not (scenario / f"remapped_{tag}.bam").exists()
    counts = _merge_shards(scenario, tag)
    assert all(0 < c < sum(counts["remapped"]) for c in counts["remapped"])
    assert counts["un"][0] > 0 and counts["un"][1] == 0
    _assert_same(scenario, f"{tag}_merged", f"{tag}_single", "jax")


def test_two_host_cram_native_merge_to_single(scenario, log_lines):
    """CRAM read input on the native feed: each shard's feeder reads only
    its owned contigs by .crai slice seek, and the merged shards equal the
    port's and the JAX package's single runs on the same CRAM."""
    from portello_tpu.io.bam import BamReader
    from portello_tpu.io.cram import CramWriter
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main

    _needs_ptscan()
    with BamReader(str(scenario / "read_to_asm.bam")) as r:
        with CramWriter(str(scenario / "read_to_asm.cram"), r.header) as w:
            for rec in r:
                w.write(rec)
    cram = {"reads": "read_to_asm.cram"}
    jax_main(_args(scenario, "cram_jax", "host", **cram))
    port_main(_args(scenario, "cram_single", "cpu", "--feed", "native", **cram))
    for h in range(2):
        port_main(_args(scenario, "cram", "cpu", "--feed", "native",
                        "--num-hosts", "2", "--host-id", str(h), **cram))
    seeks = [m for m in log_lines if m.startswith("Serving this shard's CRAM")]
    assert seeks == ["Serving this shard's CRAM reads by .crai slice seek "
                     "over 2 owned contigs"] * 2
    _merge_shards(scenario, "cram")
    _assert_same(scenario, "cram_merged", "cram_single", "cram_jax")


def _cli(args, env=None):
    p = subprocess.run(
        [sys.executable, "-m", "portello_tpu_torch.main", *args], cwd=REPO,
        env=env or _env(), capture_output=True, text=True, timeout=TIMEOUT,
    )
    return p


def _no_shards_left(d, tag):
    return not list(d.glob(f"*_{tag}.shard*"))


@pytest.mark.parametrize(
    "device,extra", [("host", ()), ("cpu", ("--feed", "native"))]
)
def test_local_workers_match_single(scenario, device, extra):
    """``--local-workers 2``: two forked workers, merged and cleaned up,
    equal to the single run."""
    from portello_tpu_torch.main import main as port_main

    if extra:
        _needs_ptscan()
    tag = f"lw_{device}"
    port_main(_args(scenario, f"{tag}_single", device, *extra))
    p = _cli(_args(scenario, tag, device, *extra, "--local-workers", "2"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "Forking 2 workers" in p.stderr
    assert p.stderr.count("Host ") == 2 and "Merged 2 worker shards" in p.stderr
    assert _no_shards_left(scenario, tag)
    _assert_same(scenario, tag, f"{tag}_single", "jax")


def test_cuda_initialized_parent_takes_subprocess_workers(
    scenario, monkeypatch, log_lines
):
    """With CUDA initialised in the parent, forked workers could not use the
    device, so the parent starts ``python -m portello_tpu_torch.main``
    workers instead."""
    import torch

    from portello_tpu_torch.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setenv("PYTHONPATH", _env()["PYTHONPATH"])
    port_main(_args(scenario, "sub", "host", "--local-workers", "2"))
    assert ("CUDA already initialized in this process; using subprocess "
            "workers") in log_lines
    assert "Starting 2 subprocess workers" in log_lines
    assert "Forking 2 workers" not in log_lines
    assert _no_shards_left(scenario, "sub")
    _assert_same(scenario, "sub", "jax")


def test_coordinator_handshake_two_processes(scenario):
    """Two hosts meet through ``torch.distributed`` (gloo on 127.0.0.1),
    each lifts its shard, and the merged shards equal the single run."""
    from portello_tpu_torch.main import main as port_main

    _needs_ptscan()
    port_main(_args(scenario, "coord_single", "cpu", "--feed", "native"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "portello_tpu_torch.main",
             *_args(scenario, "coord", "cpu", "--feed", "native",
                    "--num-hosts", "2", "--host-id", str(h),
                    "--coordinator", f"127.0.0.1:{port}")],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for h in range(2)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for h, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {h}:\n{out[-3000:]}"
        assert f"torch.distributed initialized: process {h}/2" in out
    _merge_shards(scenario, "coord")
    _assert_same(scenario, "coord_merged", "coord_single", "jax")


def test_profile_writes_trace_cpu(scenario, tmp_path, monkeypatch, log_lines):
    """``--profile DIR`` on the CPU: a Chrome trace that parses and names
    aten ops, the op table, and the native feed's timing lines."""
    from portello_tpu_torch.main import main as port_main

    _needs_ptscan()
    monkeypatch.delenv("PTPU_FEED_TIMING", raising=False)
    prof = tmp_path / "prof"
    port_main(_args(scenario, "prof", "cpu", "--feed", "native",
                    "--profile", str(prof)))
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "Self CPU" in (prof / "ops.txt").read_text()
    assert any(m.startswith("feed timing:") for m in log_lines)
    assert any(m.startswith("profile: top ops by self_cpu_time_total")
               for m in log_lines)
    _assert_same(scenario, "prof", "jax")


def test_worker_without_gpu_exits_nonzero(scenario):
    """``--local-workers 2 --device cuda`` with no GPU: every worker exits
    non-zero, the parent says which, and nothing is merged."""
    p = _cli(_args(scenario, "nogpu", "cuda", "--local-workers", "2"),
             env=_env(CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert "worker processes failed: [0, 1]" in p.stderr
    assert not (scenario / "remapped_nogpu.bam").exists()
    assert _no_shards_left(scenario, "nogpu")
