"""PyTorch port: the data-parallel mesh (``parallel/mesh.py``).

Each sharded step on a mesh of four CPU devices is bit-equal to the JAX
package's sharded step on four of the conftest's virtual CPU devices and to
the port's own single-device step; ``shard_batch`` refuses a batch the mesh
does not divide; the genome has one replica per distinct device;
``PTPU_SHARD`` reads as in the JAX package's native feed, but unset does
not shard; and the CLI with
``PTPU_SHARD=1`` over four CPU shards writes the records of ``--device
host`` and of the JAX package's sharded CLI run."""

import logging

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from portello_tpu.models.batch import BucketConfig as JaxBucketConfig
from portello_tpu.parallel import mesh as jmesh
from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.batchgen import make_item_arrays
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu_torch.graft_entry import require_equal
from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
SMALL = dict(max_ops=64, max_blocks=16, max_seq=512, max_clusters=24, window=16)
BCFG = JaxBucketConfig(**SMALL)
KW = dict(max_out=BCFG.resolved_max_out(), max_clusters=BCFG.max_clusters,
          window=BCFG.window)


def _assert_fields_equal(got: dict, want: dict, what: str) -> None:
    require_equal(got, {k: torch.from_numpy(np.array(v))
                        for k, v in want.items()}, what)


def _case(step: str, rng):
    """(JAX's sharded output, the port's sharded output, the port's
    single-device output) of ``step`` on one batch of 16 items."""
    jm = jmesh.make_mesh(4)
    pm = mesh.make_mesh(devices=[CPU] * 4)
    if step == "rev":
        items = make_item_arrays(rng, 16, BCFG, read_len=300, rev=True)
        want = jmesh.make_sharded_rev_step(jm, **KW, mm=False)(
            *jmesh.shard_batch_arrays(jm, items))
        got = mesh.make_sharded_rev_step(pm, **KW)(*items)
        single = tpm.rev_batch(*tpm.rev_batch_from_numpy(items, CPU), **KW)
        return want, got, single
    items = make_item_arrays(rng, 16, BCFG, read_len=300)
    if step == "fwd":
        want = jmesh.make_sharded_fwd_step(jm, **KW)(
            *jmesh.shard_batch_arrays(jm, items))
        got = mesh.make_sharded_fwd_step(pm, **KW)(*items)
        single = tpm.fwd_batch(*tpm.batch_from_numpy(items, CPU), **KW)
        return want, got, single
    _, res_args, words = jax_entry._resident_args_from_table(items)
    jwords = jax.device_put(words, jmesh.replicated_sharding(jm))
    want = jmesh.make_sharded_fwd_resident_step(jm, **KW)(
        *jmesh.shard_batch_arrays(jm, res_args), jwords)
    got = mesh.make_sharded_fwd_resident_step(pm, **KW)(
        *res_args, mesh.replicate(pm, words))
    single = tpm.fwd_batch_resident(
        *tpm.resident_batch_from_numpy(res_args, CPU),
        genome_tensor(words, CPU), **KW)
    return want, got, single


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("step", ["fwd", "resident", "rev"])
def test_sharded_step_equals_jax_and_single_device(step):
    want, got, single = _case(step, np.random.default_rng(31))
    _assert_fields_equal(got, want, f"{step}: port vs JAX sharded")
    require_equal(got, single, f"{step}: sharded vs single device")
    assert bool(got["mapped"].any())


def test_shard_batch_splits_rows_in_mesh_order():
    a = np.arange(24, dtype=np.int32).reshape(8, 3)
    b = np.arange(8, dtype=np.uint8)
    shards = mesh.shard_batch([CPU] * 4, (a, b))
    assert len(shards) == 4
    for i, (sa, sb) in enumerate(shards):
        assert sa.dtype == torch.int32 and sb.dtype == torch.uint8
        assert np.array_equal(sa.numpy(), a[2 * i:2 * i + 2])
        assert np.array_equal(sb.numpy(), b[2 * i:2 * i + 2])


@pytest.mark.parametrize("b,n", [(10, 4), (6, 4), (5, 2)])
def test_shard_batch_refuses_indivisible_batch(b, n):
    arrays = (np.zeros((b, 3), np.int32), np.zeros(b, np.int32))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch([CPU] * n, arrays)


def test_replicate_holds_one_copy_per_distinct_device():
    words = np.arange(64, dtype=np.uint32).reshape(4, 16)
    copies = mesh.replicate([CPU, CPU, CPU], words)
    assert len(copies) == 3
    assert len({c.data_ptr() for c in copies}) == 1
    assert copies[0].dtype == torch.uint8 and copies[0].numel() == words.nbytes


def test_make_mesh_refuses_too_few_devices():
    assert mesh.make_mesh(2, devices=["cpu"] * 3) == [CPU, CPU]
    with pytest.raises(ValueError):
        mesh.make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=[])
    if not torch.cuda.is_available():
        # no GPU: a mesh of visible devices is refused, never the CPU
        with pytest.raises(ValueError):
            mesh.make_mesh()
        assert mesh.local_devices("cuda") == []
    assert mesh.local_devices("cpu") == [CPU]


@pytest.mark.parametrize("batch_size", [32, 30])
@pytest.mark.parametrize("switch", ["1", "0", None, "true"])
def test_sharding_mesh_reads_ptpu_shard(monkeypatch, switch, batch_size):
    """On a CUDA device with four local devices (monkeypatched to CPU
    devices): ``1`` shards over all four and exits, with the JAX package's
    message, on a batch size the count does not divide; ``0`` runs on one
    device; unset (and any unknown value, such as ``true``) runs on one
    device too, unlike the JAX package's auto mode, and logs that the other
    GPUs stay idle."""
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 4)
    if switch is None:
        monkeypatch.delenv("PTPU_SHARD", raising=False)
    else:
        monkeypatch.setenv("PTPU_SHARD", switch)
    said = []
    monkeypatch.setattr(mesh.logger, "warning", said.append)
    monkeypatch.setattr(mesh.logger, "info", said.append)
    device = torch.device("cuda", 0)
    if switch == "1" and batch_size % 4:
        with pytest.raises(SystemExit, match="divisible by the 4 local"):
            mesh.sharding_mesh(device, batch_size)
        return
    got = mesh.sharding_mesh(device, batch_size)
    if switch == "1":
        assert got == [CPU] * 4 and not said
    elif switch == "0":
        assert got is None and not said
    else:
        assert got is None
        assert len(said) == 1 and "4 local GPUs visible" in said[0]


def test_sharding_mesh_unset_is_silent_on_one_device(monkeypatch):
    monkeypatch.delenv("PTPU_SHARD", raising=False)
    said = []
    monkeypatch.setattr(mesh.logger, "info", said.append)
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 4)
    assert mesh.sharding_mesh(CPU, 32) is None
    monkeypatch.setattr(mesh, "local_devices", lambda device: [device])
    assert mesh.sharding_mesh(torch.device("cuda", 0), 32) is None
    assert not said
    monkeypatch.setenv("PTPU_SHARD", "1")
    assert mesh.sharding_mesh(CPU, 30) == [CPU]


# ---------------------------------------------------------------- the CLI

def _args(d, tag, device, *extra):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / "read_to_asm.bam"),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"),
        "--device", device, "--batch-size", "32", *extra,
    ]


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_cli")
    make_scenario(str(d), rng=np.random.default_rng(22),
                  n_reads_per_contig=40, read_len=300)
    from portello_tpu.main import main as jax_main

    jax_main(_args(d, "host", "host"))
    return d


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.skipif(native_feed.get_lib() is None,
                    reason=f"ptscan unavailable: {native_feed.build_error()}")
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mode,env", [
    ("resident", {"PTPU_RESIDENT": "1"}),
    ("table", {"PTPU_RESIDENT": "0"}),
    ("devshift", {"PTPU_HOST_SHIFT": "0"}),
])
def test_sharded_cli_equals_host_and_jax(scenario, monkeypatch, mode, env):
    """``PTPU_SHARD=1 --device cpu --feed native`` over four CPU shards:
    resident slots, table slots and device-shift routing (reverse batches
    through the sharded reverse step) write the records of ``--device
    host`` and of the JAX package's sharded run on its 8 virtual
    devices."""
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.pipeline import native_feed as port_feed

    for k, v in {"PTPU_SHARD": "1", **env}.items():
        monkeypatch.setenv(k, v)
    tag = f"shard_{mode}"
    jax_main(_args(scenario, f"jax_{tag}", "cpu", "--feed", "native"))
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 4)
    stats = []
    run = port_feed.scan_and_remap_reads_native
    monkeypatch.setattr(port_feed, "scan_and_remap_reads_native",
                        lambda *a, **k: stats.append(run(*a, **k)) or stats[-1])
    lines = _Lines()
    log = logging.getLogger("portello-tpu")
    log.addHandler(lines)
    try:
        port_main(_args(scenario, tag, "cpu", "--feed", "native"))
    finally:
        log.removeHandler(lines)
    assert "Sharding batches over 4 local devices" in lines.lines
    assert len(stats) == 1 and stats[0]["shards"] == 4
    assert stats[0]["resident"] == (mode == "resident")
    assert (stats[0]["rev_batches"] > 0) == (mode == "devshift")
    for kind in ("remapped", "un"):
        port = _records(scenario / f"{kind}_{tag}.bam")
        assert port == _records(scenario / f"{kind}_host.bam"), kind
        assert port == _records(scenario / f"{kind}_jax_{tag}.bam"), kind
    assert len(_records(scenario / f"remapped_{tag}.bam")) > 0


@pytest.mark.skipif(native_feed.get_lib() is None,
                    reason=f"ptscan unavailable: {native_feed.build_error()}")
def test_forced_shard_on_indivisible_batch_exits(scenario, monkeypatch):
    """``PTPU_SHARD=1`` with a batch size the four devices do not divide
    exits before the scan, with the JAX package's message."""
    from portello_tpu_torch.main import main as port_main

    monkeypatch.setenv("PTPU_SHARD", "1")
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 4)
    args = _args(scenario, "shard_odd", "cpu", "--feed", "native")
    args[args.index("--batch-size") + 1] = "30"
    with pytest.raises(SystemExit) as e:
        port_main(args)
    assert "divisible by the 4 local devices (got 30)" in str(e.value.code)
    assert not (scenario / "remapped_shard_odd.bam").exists()
