"""PyTorch port: the native feed's stats carry the JAX package's keys, and
the companion tools write what the JAX package's write.

After the same CLI run of both packages, the port's ``_last_stats`` (and
the dict ``scan_and_remap_reads_native`` returns) holds every key of the
JAX feed's, the timers among them, with equal counts, and the scanner's
``t_native_<phase>`` timers whether ``PTPU_FEED_TIMING`` (which the port
no longer reads) is unset or set.  On one scenario's remapped BAM, the
port's ``tools.sort`` writes JAX's bytes and ``tools.index`` JAX's .bai;
``tools.view`` prints the same SAM."""

import contextlib
import io

import numpy as np
import pytest

from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.simulate import make_scenario

pytestmark = pytest.mark.skipif(
    native_feed.get_lib() is None,
    reason=f"ptscan unavailable: {native_feed.build_error()}",
)

COUNTS = ("n_primary", "device_items", "host_items", "fallback_items",
          "n_unassembled")
NATIVE_PHASES = ("read", "prepare", "fill", "drain", "post", "shift",
                 "finish_enc", "fin_encode", "fin_write")


def _args(d, tag, device, *extra):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / "read_to_asm.bam"),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"),
        "--device", device, "--batch-size", "32", *extra,
    ]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_feed_stats")
    make_scenario(str(d), rng=np.random.default_rng(24),
                  n_reads_per_contig=40, read_len=300)
    return d


@pytest.mark.parametrize("timing", [None, "1"])
def test_last_stats_carry_the_jax_keys(scenario, monkeypatch, timing):
    from portello_tpu.main import main as jax_main
    from portello_tpu_torch.main import main as port_main
    from portello_tpu_torch.pipeline import native_feed as port_feed

    if timing is None:
        monkeypatch.delenv("PTPU_FEED_TIMING", raising=False)
    else:
        monkeypatch.setenv("PTPU_FEED_TIMING", timing)
    monkeypatch.setattr(native_feed, "_last_stats", {})
    monkeypatch.setattr(port_feed, "_last_stats", {})
    returned = []
    run = port_feed.scan_and_remap_reads_native
    monkeypatch.setattr(port_feed, "scan_and_remap_reads_native",
                        lambda *a, **k: returned.append(run(*a, **k)) or returned[-1])
    jax_main(_args(scenario, f"jax_t{timing}", "cpu", "--feed", "native"))
    port_main(_args(scenario, f"port_t{timing}", "cpu", "--feed", "native"))
    want = native_feed._last_stats
    got = port_feed._last_stats
    assert got is returned[0]
    assert set(want) <= set(got), sorted(set(want) - set(got))
    timers = {"t_prep", "t_dev", "t_post"}
    native = {f"t_native_{n}" for n in NATIVE_PHASES}
    assert timers <= set(got)
    assert native <= set(got)
    for k in timers | native:
        assert isinstance(got[k], float) and got[k] >= 0.0, k
    for k in COUNTS:
        assert got[k] == want[k], k
    assert got["device_items"] > 0
    # the port's own keys stay
    assert {"resident", "h2d_bytes_per_batch", "kernel_launches",
            "shards"} <= set(got)


def _run_tool(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_sort_index_and_view_equal_jax(scenario, tmp_path):
    from portello_tpu.main import main as jax_main
    from portello_tpu.tools import index as jax_index
    from portello_tpu.tools import sort as jax_sort
    from portello_tpu.tools import view as jax_view
    from portello_tpu_torch.tools import index as port_index
    from portello_tpu_torch.tools import sort as port_sort
    from portello_tpu_torch.tools import view as port_view

    jax_main(_args(scenario, "tools", "host"))
    src = str(scenario / "remapped_tools.bam")
    outs = {}
    for name, sort, index in (("jax", jax_sort, jax_index),
                              ("port", port_sort, port_index)):
        sorted_bam = str(tmp_path / f"sorted_{name}.bam")
        sort.main([src, "-o", sorted_bam, "--threads", "2"])
        bai = _run_tool(index.main, [sorted_bam]).strip()
        assert bai == sorted_bam + ".bai"
        with open(sorted_bam, "rb") as f, open(bai, "rb") as g:
            outs[name] = (f.read(), g.read())
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    assert len(outs["port"][1]) > 0
    sam = {name: _run_tool(view.main, [str(tmp_path / f"sorted_{name}.bam")])
           for name, view in (("jax", jax_view), ("port", port_view))}
    assert sam["port"] == sam["jax"] and sam["port"].count("\n") > 1
