"""The port's bench, ``portello_tpu_torch/bench.py``, against the JAX
package's root ``bench.py``: the same synthetic items (tolerance 0), the port's
steps and native core on the bench's items equal to the JAX package's, and
``python -m portello_tpu_torch.bench`` on the CPU printing one JSON line with
every key of the JAX bench's line; without ``PTPU_BENCH_CPU=1`` and without
a card it exits non-zero.  Small sizes: B=8 items of 2 kb reads, a 1 MiB
resident table."""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from portello_tpu.models import pipeline_model as jpm
from portello_tpu.ops import native_core as jax_native
from portello_tpu.testutil.batchgen import HIFI_BUCKET as JAX_HIFI_BUCKET
from portello_tpu_torch import bench as port_bench
from portello_tpu_torch.kernels.resident import genome_tensor
from portello_tpu_torch.models import pipeline_model as tpm
from portello_tpu_torch.ops import native_core as port_native
from portello_tpu_torch.testutil.batchgen import HIFI_BUCKET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, READ_LEN, TABLE_MB = 8, 2000, 1
KW = tpm.bucket_kwargs(HIFI_BUCKET)
TINY = dict(PTPU_BENCH_BATCH="8", PTPU_BENCH_READLEN="2000",
            PTPU_BENCH_RUNS="1",
            PTPU_BENCH_E2E_READS="30", PTPU_BENCH_E2E_READLEN="2000")
# The keys the port's line adds to the JAX bench's.
ADDED_KEYS = {"t_fwd_device_ms", "t_rev_fwd_device_ms", "device_busy_share",
              "kernel_launches_per_call", "power_limit"}
# The eager protocol's fields beside the compiled step's.
EAGER_KEYS = {f"t_{leg}_eager_ms{suffix}" for leg in ("fwd", "rev_fwd")
              for suffix in ("", "_runs", "_spread")} | {
    "lone_call_eager_ms", "lone_call_eager_ms_quartiles",
    "t_fwd_eager_device_ms", "t_rev_fwd_eager_device_ms"}


def _items(bench, bucket, seed):
    """The bench's forward items, reverse items and resident inputs, drawn
    from one generator in the order its main() draws them."""
    rng = np.random.default_rng(seed)
    fwd = bench.fast_item_arrays(rng, B, bucket, READ_LEN, rev=False)
    rev = bench.fast_item_arrays(rng, B, bucket, READ_LEN, rev=True)
    res, words = bench.resident_timing_args(fwd, rng, TABLE_MB)
    return fwd, rev, res, words


@pytest.fixture(scope="module")
def items():
    return _items(port_bench, HIFI_BUCKET, 2026)


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [2026, 7])
def test_item_arrays_equal_jax_bench(seed):
    got = _items(port_bench, HIFI_BUCKET, seed)
    want = _items(jax_bench, JAX_HIFI_BUCKET, seed)
    for g, w in zip(got[:3], want[:3]):
        _assert_arrays_equal(g, w)
    _assert_arrays_equal([got[3]], [want[3]])


def _shifted_rev(rev, native):
    """The reverse items left-shifted on the host, as the bench builds its
    reverse leg: shifted cigars, the rest of the reverse items."""
    (r_ops, r_lens, r_n_ops, r_pos, r_wb, r_cwin, r_bk, r_bv, r_nb,
     r_rwin, r_rbase, r_rseq) = rev
    rel_pos = (r_pos - r_wb).astype(np.int32)
    codes, lens, n, pos = native.shift_batch(
        r_ops, r_lens, r_n_ops, rel_pos, r_cwin, r_rseq, HIFI_BUCKET.max_ops)
    ov = n < 0
    codes[ov], lens[ov] = r_ops[ov], r_lens[ov]
    n[ov], pos[ov] = r_n_ops[ov], rel_pos[ov]
    return (codes, lens, n, (pos + r_wb).astype(np.int32),
            r_bk, r_bv, r_nb, r_rwin, r_rbase, r_rseq)


@pytest.mark.parametrize("leg", ["fwd", "rev_fwd"])
def test_fwd_batch_on_bench_items_equals_jax(items, leg):
    fwd, rev, _, _ = items
    arrays = fwd if leg == "fwd" else _shifted_rev(rev, port_native)
    want = jpm.fwd_batch(*arrays, mm=False, **KW)
    got = tpm.fwd_batch(*tpm.batch_from_numpy(arrays, "cpu"), **KW)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        assert np.array_equal(got[key].numpy(), w), key
    assert bool(got["mapped"].all())


def test_fwd_batch_resident_on_bench_args_vs_jax_resident_step(items):
    """Equal on every item the JAX step does not flag; the port flags a
    subset (it has no mixed-cluster budget), as in test_torch_resident.py."""
    _, _, res, words = items
    want = jpm.fwd_batch_resident(*res, jnp.asarray(words), **KW)
    got = tpm.fwd_batch_resident(
        *tpm.resident_batch_from_numpy(res, "cpu"),
        genome_tensor(words, "cpu"), **KW)
    assert set(got) == set(want)
    jfb = np.asarray(want["fallback"])
    pfb = got["fallback"].numpy()
    assert not (pfb & ~jfb).any()
    keep = ~jfb
    assert keep.sum() >= B // 2
    for key in want:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        assert np.array_equal(got[key].numpy()[keep], w[keep]), key


def test_native_core_on_bench_items_equals_jax(items):
    fwd, rev, _, _ = items
    max_out = KW["max_out"]
    _assert_arrays_equal(port_native.lift_simplify_batch(*fwd, max_out),
                         jax_native.lift_simplify_batch(*fwd, max_out))
    r_ops, r_lens, r_n_ops, r_pos, r_wb, r_cwin = rev[:6]
    r_rseq = rev[11]
    args = (r_ops, r_lens, r_n_ops, (r_pos - r_wb).astype(np.int32), r_cwin,
            r_rseq, HIFI_BUCKET.max_ops)
    _assert_arrays_equal(port_native.shift_batch(*args),
                         jax_native.shift_batch(*args))
    shifted = _shifted_rev(rev, port_native)
    _assert_arrays_equal(shifted, _shifted_rev(rev, jax_native))
    _assert_arrays_equal(port_native.lift_simplify_batch(*shifted, max_out),
                         jax_native.lift_simplify_batch(*shifted, max_out))


def _jax_line_keys() -> set[str]:
    """The keys of the JAX bench's JSON line, read from its source: the
    dict ``main()`` prints and the e2e fields ``measure_e2e_fields``
    returns into it."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "main", "measure_e2e_fields"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys |= {k.value for k in node.keys
                             if isinstance(k, ast.Constant)}
    return keys


def _run_bench(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PTPU_") and k not in drop}
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "portello_tpu_torch.bench"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_bench_on_the_cpu_prints_every_jax_key():
    jax_keys = _jax_line_keys()
    assert {"value", "vs_baseline", "t_fwd_ms", "feed_reads_per_s",
            "e2e_reads_per_s"} <= jax_keys
    p = _run_bench(dict(TINY, PTPU_BENCH_CPU="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1, p.stdout
    line = json.loads(lines[0])
    assert jax_keys | ADDED_KEYS | EAGER_KEYS <= set(line), sorted(
        (jax_keys | ADDED_KEYS | EAGER_KEYS) - set(line))
    assert line["device"] == "cpu" and line["graph"] == "table"
    assert line["batch"] == 8 and line["e2e_scenario"] == "30x2kb"
    for key in ("value", "t_fwd_ms", "t_rev_fwd_ms", "baseline_reads_per_s",
                "e2e_reads_per_s", "feed_reads_per_s"):
        assert line[key] > 0, key
    # no CPU number under a device key; the plain versions ran, no kernel
    for key in ("t_fwd_device_ms", "t_rev_fwd_device_ms", "device_busy_share",
                "power_limit", "t_fwd_table_ms", "t_rev_devshift_chain_ms",
                "t_fwd_eager_device_ms", "t_rev_fwd_eager_device_ms"):
        assert line[key] is None, key
    for key in ("t_fwd_eager_ms", "t_rev_fwd_eager_ms", "lone_call_eager_ms"):
        assert line[key] > 0, key
    launches = line["kernel_launches_per_call"]
    assert set(launches) == {"fwd", "rev_fwd", "fwd_eager", "rev_fwd_eager"}
    assert all(n == 0 for leg in launches.values() for n in leg.values())
    assert len(line["e2e_reads_per_s_runs"]) == line["e2e_repeats"] == 3
    assert line["e2e_warmup_wall_s"] > 0 and line["e2e_n_primary"] > 0
    # one run: its pass lasted PASS_SECONDS, its spread is 1
    assert line["t_fwd_ms_runs"] == [line["t_fwd_ms"]]
    assert line["t_fwd_eager_ms_runs"] == [line["t_fwd_eager_ms"]]
    assert line["value_spread"] == line["t_fwd_ms_spread"] == 1.0
    assert line["t_rev_fwd_eager_ms_spread"] == 1.0
    assert line["calls_per_pass"] >= 1
    assert line["host_probe_us_runs"] == [line["host_probe_us"]]
    assert line["host_probe_us"] > 0
    assert line["host_cpu"]
    assert line["baseline_protocol"].startswith("median5-1t-native-mix")
    lo, hi = line["lone_call_ms_quartiles"]
    assert 0 < lo <= line["lone_call_ms"] <= hi
    lo, hi = line["lone_call_eager_ms_quartiles"]
    assert 0 < lo <= line["lone_call_eager_ms"] <= hi


@pytest.mark.parametrize("leg", ["fwd", "rev_fwd", "resident"])
def test_compiled_step_equals_eager_protocol(items, leg):
    """On the CPU the bench's compiled step (``timed_steps``) is the eager
    step on static copies of its inputs: both give the same fields on the
    bench's items, twice over, and each equals the JAX step's."""
    fwd, rev, res, words = items
    if leg == "resident":
        kind, genome = "fwd_resident", genome_tensor(words, "cpu")
        inputs = tpm.resident_batch_from_numpy(res, "cpu")
    else:
        kind, genome = "fwd", None
        arrays = fwd if leg == "fwd" else _shifted_rev(rev, port_native)
        inputs = tpm.batch_from_numpy(arrays, "cpu")
    compiled, eager = port_bench.timed_steps(kind, KW, inputs, genome)
    want = eager()
    for _ in range(2):
        got = compiled()
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key
    if leg != "resident":
        jax_out = jpm.fwd_batch(*arrays, mm=False, **KW)
        for key in want:
            assert np.array_equal(want[key].numpy(), np.asarray(jax_out[key]))


def test_bench_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run_bench(TINY, drop=("PTPU_BENCH_CPU",))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_bench_without_the_native_core_raises(monkeypatch):
    """The reverse leg's host shift and the baseline need the C++ core: a
    core that did not build ends the bench, reporting why."""
    monkeypatch.setenv("PTPU_BENCH_CPU", "1")
    monkeypatch.setenv("PTPU_BENCH_SKIP_E2E", "1")
    monkeypatch.setattr(port_native, "get_lib", lambda: None)
    monkeypatch.setattr(port_native, "build_error", lambda: "g++ exited 1")
    with pytest.raises(RuntimeError, match="native core did not build: g"):
        port_bench.main()
