"""PyTorch port: the compiled steps (``models/compiled.py``) and their
staging (``parallel/mesh.ShardedStep``), on the CPU.

On the CPU the compiled step is the eager step run on static copies of its
inputs: for each step kind it equals the eager step and the JAX package's
jitted step on the same seeded inputs (tolerance 0).  The cache gives
another entry for another bucket, batch size, shard or genome, and a step
refuses inputs it was not captured for.  The launch
bookkeeping, checked on a stub graph since nothing can be captured here:
warm-up and capture launches are kept out of ``_cuda.launch_counts`` and
every replay adds the captured counts.  The staging ring keeps two
in-flight batches apart, refuses a third, and frees the caller's arrays at
submit; a native-feed CLI run over many small batches writes the records of
``--device host`` and of the JAX package's CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from portello_tpu.models import pipeline_model as jpm
from portello_tpu.models.batch import BucketConfig as JaxBucketConfig
from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.batchgen import make_item_arrays
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu_torch.graft_entry import require_equal
from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models import compiled
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
SMALL = dict(max_ops=64, max_blocks=16, max_seq=512, max_clusters=24, window=16)
KW = tpm.bucket_kwargs(JaxBucketConfig(**SMALL))
WIDE = tpm.bucket_kwargs(JaxBucketConfig(**dict(SMALL, max_ops=96)))
B = 16
CONVERT = {"fwd": tpm.batch_from_numpy,
           "fwd_resident": tpm.resident_batch_from_numpy,
           "rev": tpm.rev_batch_from_numpy}


def _case(kind: str, seed: int, b: int = B):
    """(numpy inputs, flat genome words or None) of one batch of ``kind``."""
    rng = np.random.default_rng(seed)
    bcfg = JaxBucketConfig(**SMALL)
    if kind == "rev":
        return make_item_arrays(rng, b, bcfg, read_len=300, rev=True), None
    items = make_item_arrays(rng, b, bcfg, read_len=300)
    if kind == "fwd":
        return items, None
    _, res_args, words = jax_entry._resident_args_from_table(items)
    return res_args, words


def _jax_step(kind, arrays, words):
    if kind == "fwd":
        return jpm.fwd_batch(*arrays, mm=False, **KW)
    if kind == "rev":
        return jpm.rev_batch(*arrays, mm=False, **KW)
    return jpm.fwd_batch_resident(*arrays, jnp.asarray(words), **KW)


def _eager(kind, arrays, genome=None, kw=KW):
    extra = () if genome is None else (genome,)
    return compiled.step_function(kind, kw)(*CONVERT[kind](arrays, CPU), *extra)


def _as_tensors(out: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["fwd", "fwd_resident", "rev"])
def test_compiled_step_equals_eager_and_jax(kind):
    arrays, words = _case(kind, 41)
    genome = None if words is None else genome_tensor(words, CPU)
    want = _eager(kind, arrays, genome)
    require_equal(want, _as_tensors(_jax_step(kind, arrays, words)),
                  f"{kind}: eager vs JAX")
    step = compiled.capture(kind, KW, CONVERT[kind](arrays, CPU), genome)
    require_equal(step.replay(), want, f"{kind}: compiled vs eager")
    # the same step on other inputs through the cache and the staging
    other, _ = _case(kind, 42) if words is None else (
        tuple(np.roll(a, 3, axis=0) for a in arrays), None)
    cache = compiled.StepCache()
    genomes = None if genome is None else [genome]
    run = mesh.sharded_step(cache, kind, [CPU], B, KW, genomes)
    require_equal(run(*arrays), want, f"{kind}: staged vs eager")
    require_equal(run(*other), _eager(kind, other, genome),
                  f"{kind}: staged vs eager, second batch")
    assert bool(want["mapped"].any())


def test_cache_keys_give_another_entry_never_a_stale_one():
    cache = compiled.StepCache()
    arrays, _ = _case("fwd", 43)
    inputs = tpm.batch_from_numpy(arrays, CPU)
    first = cache.graph("fwd", KW, inputs, CPU)
    assert cache.graph("fwd", dict(KW), inputs, CPU) is first
    half = tuple(t[:B // 2] for t in inputs)
    others = [
        cache.graph("fwd", WIDE, inputs, CPU),           # another bucket
        cache.graph("fwd", KW, half, CPU),               # another B
        cache.graph("fwd", KW, inputs, CPU, shard=1),    # another shard
    ]
    assert len({id(e) for e in [first, *others]}) == 4 == len(cache.graphs())
    res, words = _case("fwd_resident", 43)
    res_in = tpm.resident_batch_from_numpy(res, CPU)
    # a CPU genome aliases its words: the second is another genome
    g1, g2 = genome_tensor(words, CPU), genome_tensor(words.copy(), CPU)
    r1 = cache.graph("fwd_resident", KW, res_in, CPU, genome=g1)
    r2 = cache.graph("fwd_resident", KW, res_in, CPU, genome=g2)
    assert r1 is not r2
    assert cache.graph("fwd_resident", KW, res_in, CPU, genome=g1) is r1
    assert len(cache.graphs()) == 6


def test_step_refuses_inputs_it_was_not_captured_for():
    res, words = _case("fwd_resident", 44)
    res_in = tpm.resident_batch_from_numpy(res, CPU)
    g = genome_tensor(words, CPU)
    step = compiled.capture("fwd_resident", KW, res_in, g)
    with pytest.raises(ValueError, match="does not fit"):
        step.launch(tuple(t[:B // 2] for t in res_in))
    with pytest.raises(ValueError, match="expected 11 inputs"):
        step.launch(res_in[:-1])
    with pytest.raises(ValueError, match="genome"):
        compiled.capture("fwd_resident", KW, res_in)
    fwd, _ = _case("fwd", 44)
    with pytest.raises(ValueError, match="genome"):
        compiled.capture("fwd", KW, tpm.batch_from_numpy(fwd, CPU), g)
    with pytest.raises(ValueError, match="unknown step kind"):
        compiled.step_function("mm", KW)
    step = mesh.ShardedStep(compiled.StepCache(), "fwd_resident", [CPU], KW,
                            [g])
    first = step.submit(*res)
    with pytest.raises(ValueError, match="read_packed"):
        step.submit(*res[:-1], res[-1][:, :-1])
    with pytest.raises(ValueError, match="ops"):
        step.submit(*(a[:B // 2] for a in res))
    # a refused batch holds no staging set: a second one still fits
    second = step.submit(*res)
    require_equal(_as_tensors(first.wait()), _as_tensors(second.wait()),
                  "resident batches around the refused ones")


class _StubGraph:
    """What ``Captured`` asks of a graph, recording its use."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def capture(self):
        self.captures += 1
        return torch.no_grad()

    def replay(self):
        self.replays += 1


def _launching_step(calls):
    """A step that launches kernel 1 twice and kernel 3 once per call, as
    the resident step does, counted by the wrappers' own ``check``."""

    def step(x):
        calls.append(1)
        for name in ("cleanup_and_compress", "cleanup_and_compress",
                     "window_match"):
            _cuda.check(0, name)
        return {"y": x + 1}

    return step


def test_replays_count_the_captured_launches(monkeypatch):
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.launch_counts, 5))
    calls = []
    stub = _StubGraph()
    step = compiled.Captured(_launching_step(calls),
                             (torch.arange(4, dtype=torch.int32),), graph=stub)
    # warm-up and capture ran the step, and counted nothing
    assert len(calls) == compiled.WARMUP_CALLS + 1 and stub.captures == 1
    assert _cuda.launch_counts == dict.fromkeys(_cuda.launch_counts, 5)
    assert step.launches == {"cleanup_and_compress": 2, "match_run": 0,
                             "window_match": 1}
    for n in range(1, 4):
        out = step.replay()
        assert out is step.outputs and stub.replays == n
        assert _cuda.launch_counts == {"cleanup_and_compress": 5 + 2 * n,
                                       "match_run": 5, "window_match": 5 + n}
    # a replay runs no Python of the step
    assert len(calls) == compiled.WARMUP_CALLS + 1
    step.launch((torch.zeros(4, dtype=torch.int32),))
    assert step.replays == 4 and _cuda.launch_counts["window_match"] == 9


def test_uncounted_restores_the_counts_when_the_block_raises(monkeypatch):
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.launch_counts, 0))
    with pytest.raises(RuntimeError, match="capture failed"):
        with compiled.uncounted() as made:
            _cuda.check(0, "match_run")
            raise RuntimeError("capture failed")
    assert made == {"cleanup_and_compress": 0, "match_run": 1,
                    "window_match": 0}
    assert _cuda.launch_counts == dict.fromkeys(_cuda.launch_counts, 0)


@pytest.mark.parametrize("kind", ["fwd", "fwd_resident", "rev"])
def test_two_batches_in_flight_stay_apart(kind):
    """Two shards, two batches submitted before either is waited on: each
    batch's outputs are its own eager step's, whatever the other wrote."""
    a, words = _case(kind, 45)
    genome = None if words is None else genome_tensor(words, CPU)
    b = tuple(np.ascontiguousarray(x[::-1]) for x in a)
    step = mesh.ShardedStep(compiled.StepCache(), kind, [CPU, CPU], KW,
                            None if genome is None else [genome, genome])
    ha, hb = step.submit(*a), step.submit(*b)
    got_b, got_a = hb.wait(), ha.wait()
    require_equal(_as_tensors(got_a), _eager(kind, a, genome), f"{kind} A")
    require_equal(_as_tensors(got_b), _eager(kind, b, genome), f"{kind} B")
    assert not np.array_equal(got_a["codes"], got_b["codes"])


def test_a_third_batch_in_flight_is_refused():
    a, _ = _case("fwd", 46)
    step = mesh.ShardedStep(compiled.StepCache(), "fwd", [CPU], KW)
    first = step.submit(*a)
    step.submit(*a)
    with pytest.raises(RuntimeError, match="more than 2 batches in flight"):
        step.submit(*a)
    first.wait()
    # the refused call took no staging set: the next one reuses the first's
    third = step.submit(*a)
    assert third.outputs is first.outputs


def test_submit_frees_the_callers_arrays():
    """The slot's arrays are copied at submit: the C++ scanner may refill
    them before the batch is waited on."""
    a, _ = _case("rev", 47)
    want = _eager("rev", a)
    slot = tuple(x.copy() for x in a)
    step = mesh.ShardedStep(compiled.StepCache(), "rev", [CPU], KW)
    handle = step.submit(*slot)
    for x in slot:
        x[...] = np.flip(x, axis=0)
    require_equal(_as_tensors(handle.wait()), want, "rev after the refill")


def _args(d, tag, device, *extra):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / "read_to_asm.bam"),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"),
        "--device", device, "--batch-size", "8", *extra,
    ]


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    from portello_tpu.main import main as jax_main

    d = tmp_path_factory.mktemp("torch_compiled_cli")
    make_scenario(str(d), rng=np.random.default_rng(25),
                  n_reads_per_contig=12, read_len=300)
    jax_main(_args(d, "host", "host"))
    jax_main(_args(d, "jax", "cpu", "--feed", "native"))
    return d


@pytest.mark.skipif(native_feed.get_lib() is None,
                    reason=f"ptscan unavailable: {native_feed.build_error()}")
@pytest.mark.parametrize("mode,env", [
    ("resident", {}),
    ("table", {"PTPU_RESIDENT": "0"}),
    ("devshift", {"PTPU_HOST_SHIFT": "0"}),
])
def test_native_cli_over_many_batches_equals_host_and_jax(scenario,
                                                          monkeypatch, mode,
                                                          env):
    """``--batch-size 8`` makes many batches, so each staging set of a step
    is reused while the other's batch is in flight."""
    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.pipeline import native_feed as port_feed

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port_main(_args(scenario, mode, "cpu", "--feed", "native"))
    stats = port_feed._last_stats
    n_batches = sum(stats["batches_per_bucket"])
    assert n_batches >= 3
    assert stats["replays"] == n_batches and stats["compiled_steps"] >= 1
    assert (stats["rev_batches"] > 0) == (mode == "devshift")
    for kind in ("remapped", "un"):
        port = _records(scenario / f"{kind}_{mode}.bam")
        assert port == _records(scenario / f"{kind}_host.bam"), kind
        assert port == _records(scenario / f"{kind}_jax.bam"), kind
    assert len(_records(scenario / f"remapped_{mode}.bam")) > 0
