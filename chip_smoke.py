#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``portello_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  -- requires a CUDA device; prints its name and nvidia-smi's
   name and power limit.
2. build   -- builds the CUDA kernels (nvcc, sm_90a) and the native scanner.
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the forward step's shapes, with equality required (tolerance 0: all data
   is integers); median CUDA-event times of both.
4. forward -- the forward step at B=512 HiFi items (18 kb, primary bucket)
   on CUDA against the same step on the CPU, every output field equal;
   ms/batch and items/s, fallback count, kernel launches.
5. e2e     -- the CLI (``python -m portello_tpu_torch.main --device cuda
   --feed native``) on the 18 kb bench scenario; sorted SAM records must
   equal the exact host path's (``python -m portello_tpu.main --device
   host``); wall seconds, reads/s, item counts, kernel launches.

Imports nothing of JAX.  The last line of stdout is the JSON device record.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_ms(fn, reps: int = 20) -> tuple[float, str]:
    """Milliseconds per call of ``fn``: the device time of the kernels it
    launches, from ``torch.profiler`` over ``reps`` calls.  Where the
    profiler records no device kernels, the CUDA-event time per call over a
    loop of ``reps`` calls instead (host launch overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if dev:
        return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps, "device"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events"


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired outputs, compared as int64."""
    import torch

    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"output shape/dtype differ: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi_line}")
    return name, smi_line


# ---------------------------------------------------------------- phase 2
def phase_build():
    from portello_tpu.pipeline.native_feed import build_error, get_lib
    from portello_tpu_torch.kernels import _cuda

    t0 = time.perf_counter()
    _cuda.get_lib()
    log(f"build: CUDA kernels {_cuda.build_seconds:.1f} s (nvcc "
        f"{' '.join(_cuda.NVCC_FLAGS[:2])}) -> {os.path.relpath(_cuda.SO_PATH, HERE)}")
    t1 = time.perf_counter()
    lib = get_lib()
    require(lib is not None, f"native scanner (ptscan) build failed: {build_error()}")
    log(f"build: native scanner ready in {time.perf_counter() - t1:.1f} s; "
        f"total {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 3
def compress_case(rng, b: int, k: int):
    """Random op streams with zero lengths, PAD runs and edge indels."""
    import numpy as np

    codes = rng.integers(0, 10, size=(b, k)).astype(np.int32)
    lens = rng.integers(0, 24000, size=(b, k)).astype(np.int32)
    lens[rng.random((b, k)) < 0.3] = 0
    # long runs of one code, so some rows compress below max_out
    for i in range(8, b, 3):
        codes[i] = np.repeat(rng.integers(0, 10, size=k // 8 + 1), 8)[:k]
    # PAD tails of varied length
    for i in range(4, b, 5):
        codes[i, rng.integers(0, k):] = 9
    codes[0, :] = 9                     # all PAD
    lens[1, :] = 0                      # all zero length
    codes[2, :] = 9
    codes[2, 0], lens[2, 0] = 0, 5      # one op
    codes[3, :4] = [2, 1, 0, 2]         # D I M D: edge indels on both sides
    lens[3, :4] = [3, 2, 7, 4]
    codes[3, 4:] = 9
    return codes, lens


def match_case(rng, b: int, c: int, w: int, length: int):
    """Mostly-equal rows (runs of every length) and starts over [-W, L]."""
    import numpy as np

    a = rng.integers(65, 69, size=(b, length), dtype=np.uint8)
    bb = a.copy()
    mut = rng.random((b, length)) < 0.03
    bb[mut] = rng.integers(60, 64, size=int(mut.sum()), dtype=np.uint8)
    bb[:, -64:] = 0  # in-row zero padding compares as data
    a[:, -32:] = 0
    ia = rng.integers(-w, length + 1, size=(b, c)).astype(np.int32)
    shift = np.where(rng.random((b, c)) < 0.8, 0,
                     rng.integers(-3, 4, size=(b, c)))
    ib = np.clip(ia + shift, -w, length).astype(np.int32)
    ia[:, 0], ib[:, 0] = -w, -w          # the domain's ends
    ia[:, 1], ib[:, 1] = length, length
    ia[:, 2], ib[:, 2] = 0, 0
    limit = rng.integers(-2, w + 9, size=(b, c)).astype(np.int32)
    return a, bb, ia, ib, limit


def _timed(kernel, plain):
    """(kernel ms, plain ms, log text): device time per call, and the
    CUDA-event time of one call with its host overhead."""
    ms, how = call_ms(kernel)
    pms, phow = call_ms(plain)
    return ms, pms, (
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms ({how}/{phow} time per "
        f"call); one call with host overhead (CUDA events): kernel "
        f"{cuda_ms(kernel):.4f} ms, plain {cuda_ms(plain):.4f} ms"
    )


def phase_kernels(rng):
    import torch

    from portello_tpu_torch.kernels.cigar_kernels import (
        cleanup_and_compress_cuda,
        cleanup_and_compress_plain,
    )
    from portello_tpu_torch.kernels.cluster_utils import (
        match_run_cuda,
        match_run_plain,
    )

    dev = torch.device("cuda")
    results = {}
    # (K, max_out): the lift site (2U = 352) and finish site (2 * max_out =
    # 464) of the primary bucket, and both sites of the widest bucket.
    err1 = 0
    for k, max_out in ((352, 232), (464, 232), (2816, 1800), (3600, 1800)):
        codes, lens = compress_case(rng, 512, k)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        got = cleanup_and_compress_cuda(c, ln, max_out)
        want = cleanup_and_compress_plain(c, ln, max_out)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"cleanup_and_compress K={k}: kernel != plain "
                f"(max abs err {err})")
        err1 = max(err1, err)
        ms, pms, times = _timed(
            lambda: cleanup_and_compress_cuda(c, ln, max_out),
            lambda: cleanup_and_compress_plain(c, ln, max_out),
        )
        n_ovf = int(got[4].sum())
        log(f"kernel cleanup_and_compress B=512 K={k} max_out={max_out}: "
            f"equal (overflow rows {n_ovf}); {times}")
        if (k, max_out) == (352, 232):
            results["cleanup_and_compress"] = (ms, pms)
    results["cleanup_and_compress_err"] = err1

    err2 = 0
    for c_, length in ((96, 24576), (512, 65536)):
        w = 48
        a, bb, ia, ib, limit = match_case(rng, 512, c_, w, length)
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(bb).to(dev)
        tia, tib = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
        tl = torch.from_numpy(limit).to(dev)
        for rev in (False, True):
            got = match_run_cuda(ta, tia, tb, tib, tl, w, rev)
            want = match_run_plain(ta, tia, tb, tib, tl, w, rev)
            torch.cuda.synchronize()
            err = max_abs_err([got], [want])
            require(err == 0, f"match_run C={c_} L={length} rev={rev}: "
                    f"kernel != plain (max abs err {err})")
            err2 = max(err2, err)
            ms, pms, times = _timed(
                lambda: match_run_cuda(ta, tia, tb, tib, tl, w, rev),
                lambda: match_run_plain(ta, tia, tb, tib, tl, w, rev),
            )
            log(f"kernel match_run B=512 C={c_} W={w} L={length} "
                f"{'backward' if rev else 'forward'}: equal (mean run "
                f"{float(got.float().mean()):.2f}); {times}")
            if (c_, rev) == (96, True):
                results["match_run"] = (ms, pms)
    results["match_run_err"] = err2
    return results


# ---------------------------------------------------------------- phase 4
def phase_forward(rng):
    import torch

    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
    )
    from portello_tpu_torch.testutil.batchgen import make_item_arrays

    bcfg = DEFAULT_BUCKETS[0]
    b = 512
    t0 = time.perf_counter()
    arrays = make_item_arrays(rng, b, bcfg, read_len=18000)
    log(f"forward: built {b} HiFi items (18 kb) in {time.perf_counter() - t0:.1f} s")
    kw = bucket_kwargs(bcfg)
    t0 = time.perf_counter()
    want = fwd_batch(*batch_from_numpy(arrays, "cpu"), **kw)
    cpu_s = time.perf_counter() - t0
    gpu_args = batch_from_numpy(arrays, torch.device("cuda"))

    _cuda.reset_launch_counts()
    got = fwd_batch(*gpu_args, **kw)
    torch.cuda.synchronize()
    launches = dict(_cuda.launch_counts)
    for name, n in launches.items():
        require(n > 0, f"forward step launched no {name} kernel")
    for key in want:
        g = got[key].cpu()
        require(g.dtype == want[key].dtype and torch.equal(g, want[key]),
                f"forward step field {key!r}: CUDA != CPU")
    n_fb = int(want["fallback"].sum())
    n_mapped = int(want["mapped"].sum())

    def step():
        fwd_batch(*gpu_args, **kw)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    samples = []
    for _ in range(25):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(samples)
    ev_ms = cuda_ms(step, reps=20)
    dev_ms, how = call_ms(step, reps=10)
    log(f"forward B={b} K_lift={2 * kw['max_rows']} max_out={kw['max_out']}: "
        f"CUDA == CPU on all {len(want)} fields; mapped {n_mapped}, fallback "
        f"{n_fb}; launches {json.dumps(launches)}")
    log(f"forward: {ms:.3f} ms/batch (median of {len(samples)}, host clock + "
        f"sync), {ev_ms:.3f} ms (CUDA events), {b / (ms / 1e3):.0f} items/s; "
        f"CPU plain step {cpu_s:.2f} s")
    log(f"forward: {how} time {dev_ms:.3f} ms/batch, busy share "
        f"{dev_ms / ms:.3f} of the host-clock step")
    return launches


# ---------------------------------------------------------------- phase 5
_LIFTED = re.compile(
    r"Lifted (\d+) primary reads: (\d+) device work items, (\d+) host items "
    r"\((\d+) window/bucket fallbacks\)"
)
_LAUNCHES = re.compile(r"kernel launches: (\{.*\})")
_TIMING_LINES = ("feed timing:", "native phase split:", "Total Runtime:")


def _sam_records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(path) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def _cli(module, d, tag, device, extra=()):
    env = dict(os.environ, PTPU_FEED_TIMING="1")
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [
        sys.executable, "-m", module,
        "--assembly-to-ref", os.path.join(d, "asm_to_ref.bam"),
        "--read-to-assembly", os.path.join(d, "read_to_asm.bam"),
        "--remapped-read-output", os.path.join(d, f"remapped_{tag}.bam"),
        "--unassembled-read-output", os.path.join(d, f"un_{tag}.bam"),
        "--ref", os.path.join(d, "ref.fa"), "--device", device, *extra,
    ]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    require(p.returncode == 0,
            f"{module} --device {device} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return wall, p.stderr


def phase_e2e():
    import numpy as np

    from portello_tpu.testutil.simulate import make_scenario

    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as d:
        t0 = time.perf_counter()
        make_scenario(d, rng=np.random.default_rng(99), n_reads_per_contig=400,
                      read_len=18000, chrom_len=200000)
        log(f"e2e: bench scenario (4 contigs x 400 reads x 18 kb) built in "
            f"{time.perf_counter() - t0:.1f} s")
        threads = str(os.cpu_count() or 1)
        # The CLI runs in its own process, whose launch counts start at 0;
        # it logs the launches of its phase-2 run ("kernel launches: {...}").
        wall, err = _cli("portello_tpu_torch.main", d, "cuda", "cuda",
                         ("--feed", "native", "--threads", threads))
        m = _LIFTED.search(err)
        lm = _LAUNCHES.search(err)
        require(m is not None and lm is not None,
                f"port CLI log lacks its stats lines:\n{err[-3000:]}")
        n_primary, dev_items, host_items, fb_items = map(int, m.groups())
        launches = json.loads(lm.group(1))
        for line in err.splitlines():
            if any(k in line for k in _TIMING_LINES):
                log("e2e port CLI: " + line.split("] ", 1)[-1])
        for name, n in launches.items():
            require(n > 0, f"e2e run launched no {name} kernel")
        host_wall, _ = _cli("portello_tpu.main", d, "host", "host",
                            ("--threads", threads))
        for kind in ("remapped", "un"):
            got = _sam_records(os.path.join(d, f"{kind}_cuda.bam"))
            want = _sam_records(os.path.join(d, f"{kind}_host.bam"))
            require(got == want, f"e2e {kind} records differ from --device "
                    f"host ({len(got)} vs {len(want)} records)")
            if kind == "remapped":
                require(len(got) > 0, "e2e produced no remapped records")
                n_records = len(got)
    log(f"e2e: --device cuda output == --device host output ({n_records} "
        f"remapped records, sorted SAM)")
    log(f"e2e: port CLI wall {wall:.2f} s for {n_primary} primary reads = "
        f"{n_primary / wall:.1f} reads/s (whole process: start, phase 1, "
        f"phase 2); device items {dev_items}, host items {host_items}, "
        f"fallbacks {fb_items}; launches {json.dumps(launches)}; host-path "
        f"CLI wall {host_wall:.2f} s")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"[chip_smoke] FAIL: torch unavailable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        name, smi_line = phase_device()
        phase_build()
        rng = np.random.default_rng(SEED)
        kres = phase_kernels(rng)
        phase_forward(rng)
        e2e_launches = phase_e2e()
        require("jax" not in sys.modules, "jax was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    kernels = [
        {
            "name": "cleanup_and_compress", "route": "cuda",
            "source": "portello_tpu_torch/csrc/compress.cu",
            "replaces": "portello_tpu/kernels/pallas/compress_pallas.py:124",
            "launches": e2e_launches["cleanup_and_compress"],
            "max_abs_err": kres["cleanup_and_compress_err"],
            "ms": kres["cleanup_and_compress"][0],
            "plain_ms": kres["cleanup_and_compress"][1],
        },
        {
            "name": "match_run", "route": "cuda",
            "source": "portello_tpu_torch/csrc/match_run.cu",
            "replaces": "portello_tpu/kernels/pallas/match_run_pallas.py:78",
            "launches": e2e_launches["match_run"],
            "max_abs_err": kres["match_run_err"],
            "ms": kres["match_run"][0],
            "plain_ms": kres["match_run"][1],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
