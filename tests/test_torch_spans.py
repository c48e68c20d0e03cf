"""PyTorch port: the spans and wait counters of a CLI call on the native feed.

The recorder's phases meet at one instant and a closed span closes what it
holds.  On a CPU run of a simulated scenario: the span tree is well formed and the
main thread's phases cover the call; ``clock_offset_ns`` puts the call where
``torch.profiler`` saw it; the wait, CPU and host-path counters agree with
the feed's timers and the process's CPU clock; ``--profile`` writes the
spans into its Chrome trace.  On the card, the genome's upload span
encloses its staged copies to the device, from pinned memory:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda

(this file imports no JAX; ``--noconftest`` skips the suite's JAX set-up).
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portello_tpu_torch import main as port
from portello_tpu_torch.pipeline import native_feed
from portello_tpu_torch.testutil.simulate import make_scenario
from portello_tpu_torch.utils.spans import CallSpans

ROLES = {"main", "producer", "prep", "readahead", "finisher", "deflate",
         "writer_io"}
PER_BATCH = ("dispatch.submit", "dispatch.wait", "post.intake")


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    if native_feed.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {native_feed.build_error()}")
    d = tmp_path_factory.mktemp("torch_spans")
    make_scenario(str(d), rng=np.random.default_rng(31),
                  n_reads_per_contig=40, read_len=300)
    return d


def _args(d, tag, device, *extra):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / "read_to_asm.bam"),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"), "--device", device, "--feed", "native",
        "--batch-size", "32", "--threads", "3", *extra,
    ]


@pytest.fixture(scope="module")
def traced(scenario):
    """One ``main.run`` on the CPU inside a ``record_function`` under
    ``torch.profiler``: the stats, the span's start and end on the
    profiler's clock, and the process's CPU seconds over the run."""
    settings = port.validate_and_fix_settings(
        port.parse_settings(_args(scenario, "traced", "cpu")))
    port.run(settings)  # builds the scanner and warms up
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.run"):
            cpu0 = time.process_time()
            port.run(settings)
            cpu = time.process_time() - cpu0
    event = next(e for e in prof.profiler.kineto_results.events()
                 if e.name() == "test.run")
    start = event.start_ns()
    return dict(native_feed._last_stats), (start, start + event.duration_ns()), cpu


def test_span_tree_is_well_formed_and_covers_the_call(traced):
    stats, _, _ = traced
    spans = stats["spans"]
    assert spans[0][:3] == ["call", -1, "main"]
    for i, (name, parent, role, t0, t1) in enumerate(spans):
        assert 0 < t0 <= t1, name
        assert role in ROLES, name
        if i:
            assert 0 <= parent < len(spans) and parent != i, name
            _, _, _, p0, p1 = spans[parent]
            assert p0 <= t0 and t1 <= p1, (name, spans[parent][0])
    names = [s[0] for s in spans]
    children = [s[0] for s in spans if s[1] == 0 and s[2] == "main"]
    assert children == ["startup", "feed", "finish"]
    for name in ("startup.chrom_lists", "startup.contig_index",
                 "startup.genome_build", "startup.genome_upload",
                 "startup.scanner", "finish.scanner", "finish.destroy",
                 "producer", "producer.first_slot", "finisher",
                 "writer.close.remapped", "writer.close.unassembled"):
        assert names.count(name) == 1, name
    batches = sum(stats["batches_per_bucket"])
    assert batches >= 3
    for name in PER_BATCH:
        assert names.count(name) == batches, name
    # one more call ends the feed (0), and at most one more drains the
    # last batch at the end of input (2)
    assert batches + 1 <= names.count("feed.next_batch") <= batches + 2
    call = spans[0][4] - spans[0][3]
    covered = sum(s[4] - s[3] for s in spans if s[1] == 0 and s[2] == "main")
    assert covered >= 0.98 * call


def test_recorder_phases_meet_and_close_what_they_hold():
    """The recorder alone: each phase opens at the instant the last one
    closed, a span added without a parent nests in the innermost open span,
    and closing a span closes the spans still open inside it, at once."""
    rec = CallSpans("call")
    first = rec.phase("startup")
    inner = rec.open("startup.inner")
    t = time.monotonic_ns()
    added = rec.add("native", t, t, role="producer")
    second = rec.phase("feed")
    rec.close_all()
    spans = rec.spans
    assert spans[first][4] == spans[second][3] > 0
    assert spans[inner][4] == spans[first][4]
    assert spans[added][1] == inner and spans[added][2] == "producer"
    assert spans[second][1] == 0 and spans[0][4] == spans[second][4]
    assert rec.cpu_s["main"] >= 0.0


def test_clock_offset_places_the_call_on_the_profiler_clock(traced):
    stats, (start, end), _ = traced
    _, _, _, t0, t1 = stats["spans"][0]
    off = stats["clock_offset_ns"]
    slack = 2_000_000
    assert start - slack <= t0 + off <= t1 + off <= end + slack
    assert isinstance(stats["call_id"], str) and stats["call_id"]


def test_counters_agree_with_the_timers_and_the_cpu_clock(traced):
    stats, _, cpu = traced
    wait = stats["wait_s"]
    assert set(wait) == set(stats["waits"])
    for key, seconds in wait.items():
        site, role = key.rsplit("@", 1)
        assert site and role in ROLES, key
        assert seconds > 0 and stats["waits"][key] >= 1, key
    assert wait.get("next_batch ready@main", 0.0) <= stats["t_prep"]
    assert wait.get("drain_fifo fin space@producer", 0.0) <= stats["t_native_drain"]
    assert set(stats["host_lift_s"]) == {"prep", "post"}
    assert stats["host_lift_s"]["post"] <= stats["t_native_post"]
    assert min(stats["host_lift_s"].values()) >= 0.0
    assert set(stats["cpu_s"]) == ROLES
    assert min(stats["cpu_s"].values()) >= 0.0
    assert sum(stats["cpu_s"].values()) <= cpu * 1.05
    assert stats["t_prep"] == pytest.approx(sum(
        (s[4] - s[3]) / 1e9 for s in stats["spans"] if s[0] == "feed.next_batch"))


def _trace(path):
    with open(path) as f:
        return json.load(f)


def _spans(trace):
    return {e["name"]: e for e in trace["traceEvents"]
            if e.get("cat") == "portello_span"}


def test_profile_trace_holds_the_spans(scenario, tmp_path):
    port.main(_args(scenario, "prof", "cpu", "--profile", str(tmp_path)))
    trace = _trace(tmp_path / "trace.json")
    spans = _spans(trace)
    stats = native_feed._last_stats
    assert set(spans) == {s[0] for s in stats["spans"]}
    rows = {e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"portello main", "portello producer", "portello finisher"} <= rows
    # on the trace's clock: the feed lies inside the profiler's window
    base = int(trace.get("baseTimeNanoseconds", 0))
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") != "portello_span"]
    first = min(e["ts"] for e in ops)
    last = max(e["ts"] + e["dur"] for e in ops)
    feed = spans["feed"]
    assert first - 2000 <= feed["ts"] and feed["ts"] + feed["dur"] <= last + 2000
    _, _, _, t0, _ = next(s for s in stats["spans"] if s[0] == "feed")
    assert feed["ts"] == pytest.approx(
        (t0 + stats["clock_offset_ns"] - base) / 1e3, abs=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_genome_upload_span_encloses_its_copy(scenario, tmp_path, cuda_device):
    port.main(_args(scenario, "prof_cuda", cuda_device, "--profile", str(tmp_path)))
    trace = _trace(tmp_path / "trace.json")
    spans = _spans(trace)
    upload = spans["startup.genome_upload"]
    # the genome's copies are the call's only ones before its scanner
    copies = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and "HtoD" in e.get("name", "")
              and e["ts"] < spans["startup.scanner"]["ts"]]
    assert len(copies) == native_feed._last_stats["genome_chunks"] > 0
    slack = 1000  # us
    for genome in copies:
        assert "Pinned" in genome["name"]
        assert upload["ts"] - slack <= genome["ts"]
        assert genome["ts"] + genome["dur"] <= upload["ts"] + upload["dur"] + slack
    assert os.path.getsize(tmp_path / "ops.txt") > 0
