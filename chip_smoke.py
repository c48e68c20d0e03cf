#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``portello_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  -- requires a CUDA device; prints its name and nvidia-smi's
   name and power limit.
2. build   -- builds the CUDA kernels (nvcc, sm_90a, one process per
   source) and the native scanner.
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the device steps' shapes, with equality required (tolerance 0: all data
   is integers); median CUDA-event times of both.  Kernel 1 also runs on
   the reverse step's stage-B emission streams (K=257 and K=2049, odd
   widths with zero-length non-PAD ops), kernel 2 on stage A's homology
   runs (backward, contig windows, limits up to the read length).  The
   window-runs kernel runs both of its contracts, the resident one on a
   synthetic 3.1 Gbp genome on the card (offsets past 2^31, windows at the
   genome's end).
4. steps   -- at B=512 HiFi items (18 kb, primary bucket): the forward step
   in both slot modes (the table step on CUDA against the CPU; the resident
   step, items placed in a 3.1 GB genome, on CUDA against the table step
   and against the resident step on the CPU) and the reverse step
   ``rev_batch`` on CUDA against the CPU, at window base 0 and with half the
   items at nonzero window bases; every output field equal; ms/batch of
   each step, device busy share, H2D bytes, fallback count, kernel launches
   per path.
5. e2e     -- the CLI (``python -m portello_tpu_torch.main --device cuda``)
   on the 18 kb bench scenario: the native feed in resident slot mode (the
   default), on table slots (``PTPU_RESIDENT=0``) and under device-shift
   routing (``PTPU_HOST_SHIFT=0``, reverse batches on table slots); the
   Python feed under host-shift and under device-shift routing.  The sorted
   SAM records of each must equal the exact host path's (``python -m
   portello_tpu.main --device host``); wall seconds, reads/s, item counts,
   H2D bytes per batch, reverse batches, kernel launches per path.

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
GENOME_BYTES = 3_100_000_000  # GRCh38-sized resident genome (64-aligned)
W = 48                        # the buckets' simplify window

KERNELS = ("cleanup_and_compress", "match_run", "window_match")

# The kernels each path must launch, read from the launch counts of one run;
# it must launch no other.
PATH_KERNELS = {
    "resident": ("cleanup_and_compress", "window_match"),
    "table": ("cleanup_and_compress", "match_run"),
    "rev": ("cleanup_and_compress", "match_run"),
    "native_devshift": ("cleanup_and_compress", "match_run"),
    "python": ("cleanup_and_compress", "match_run"),
    "python_devshift": ("cleanup_and_compress", "match_run"),
}


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


def call_ms(fn, reps: int = 20) -> tuple[float, str, float]:
    """Milliseconds per call of ``fn``: the device time of the kernels it
    launches, from ``torch.profiler`` over ``reps`` calls.  Where the
    profiler records no device kernels, the CUDA-event time per call over a
    loop of ``reps`` calls instead (host launch overhead included).  The
    third value is the device activities (kernels and copies) per call, 0
    where the profiler saw none."""
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
        return (sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps,
                "device", len(dev) / reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events", 0.0


def require_launches(launches: dict, path: str, where: str) -> None:
    """The kernels of ``path`` launched at least once, the others never."""
    for name in KERNELS:
        if name in PATH_KERNELS[path]:
            require(launches.get(name, 0) > 0, f"{where}: no {name} launch")
        else:
            require(launches.get(name, 0) == 0,
                    f"{where}: {name} launched on the {path} path")


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
    ms, how, _ = call_ms(kernel)
    pms, phow, _ = call_ms(plain)
    return ms, pms, (
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms ({how}/{phow} time per "
        f"call); one call with host overhead (CUDA events): kernel "
        f"{cuda_ms(kernel):.4f} ms, plain {cuda_ms(plain):.4f} ms"
    )


def phase_kernels(rng, rev_arrays):
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
    shift = phase_shift_kernels(rng, rev_arrays)
    results["cleanup_and_compress_err"] = max(err1, shift.pop("compress_err"))
    results["match_run_err"] = max(err2, shift.pop("match_run_err"))
    results.update(shift)
    results.update(phase_window_match(rng))
    return results


def with_zero_length_clips(arrays):
    """A copy of a ``rev_batch`` batch in which every third item starts
    with a zero-length soft clip and every third other item ends with one.
    Stage B keeps such an op as a real code (``keep_zero``), so kernel 1
    sees zero-length non-PAD ops.  (The feeds send reverse items with a
    zero-length op to the host, so the main path does not produce them.)"""
    from portello_tpu_torch.kernels.cigar_kernels import S

    ops, lens, n_ops = (a.copy() for a in arrays[:3])
    for i in range(len(n_ops)):
        n = int(n_ops[i])
        if i % 3 == 2 or n >= ops.shape[1]:
            continue
        at = 0 if i % 3 == 0 else n
        ops[i, at + 1:n + 1] = ops[i, at:n].copy()
        lens[i, at + 1:n + 1] = lens[i, at:n].copy()
        ops[i, at], lens[i, at] = S, 0
        n_ops[i] = n + 1
    return (ops, lens, n_ops) + tuple(arrays[3:])


def shift_case(arrays, bcfg):
    """The reverse step's kernel inputs for a ``rev_batch`` batch, from the
    plain stage A on the CPU: stage B's emission stream (B, 2n+1) before its
    compress, and stage A's homology-run arguments (contig windows, suffix
    ends, limits)."""
    from portello_tpu_torch.kernels.cluster_utils import find_clusters
    from portello_tpu_torch.kernels.shift_kernel import (
        homology_run_args,
        shift_stage_a,
        shift_stage_b_emit,
    )
    from portello_tpu_torch.models.pipeline_model import rev_batch_from_numpy

    t = rev_batch_from_numpy(arrays, "cpu")
    ops, lens, wb, cwin, rseq = t[0], t[1], t[4], t[5], t[11]
    rel = t[3] - wb
    st = shift_stage_a(ops, lens, rel, wb, cwin, rseq,
                       max_clusters=bcfg.max_clusters, window=bcfg.window)
    codes, elens, _ = shift_stage_b_emit(ops, lens, st, window=bcfg.window)
    cl = find_clusters(ops, lens, rel, bcfg.max_clusters)
    end_ref, end_read, limit = homology_run_args(cl, wb)
    return (codes, elens), (cwin, end_ref.contiguous(), rseq,
                            end_read.contiguous(), limit.contiguous())


def phase_shift_kernels(rng, rev_arrays):
    """Kernels 1 and 2 on the inputs the reverse step gives them: stage B's
    emission streams (odd K, zero-length non-PAD ops, a trailing flush in a
    partial last 32-lane chunk) and stage A's homology runs (backward, on
    contig windows, limits far above the window).  The primary bucket's
    case is the B=512 batch of phase 4; the widest bucket's is 64 items with
    half of them at nonzero window bases, each row repeated 8 times; in
    both, two items in three carry a zero-length soft clip."""
    import torch

    from portello_tpu_torch.kernels.cigar_kernels import (
        M,
        PAD,
        cleanup_and_compress_cuda,
        cleanup_and_compress_plain,
    )
    from portello_tpu_torch.kernels.cluster_utils import (
        match_run_cuda,
        match_run_plain,
    )
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        _rev_ops_bound,
    )
    from portello_tpu_torch.testutil.batchgen import (
        make_item_arrays,
        shift_win_base,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    wide = DEFAULT_BUCKETS[2]
    wide_arrays, _ = shift_win_base(make_item_arrays(
        rng, 64, wide, read_len=18000, read_error=0.03, rev=True), rng)
    cases = []
    for label, arrays, bcfg, rep in (
        ("primary bucket", with_zero_length_clips(rev_arrays),
         DEFAULT_BUCKETS[0], 1),
        ("widest bucket", with_zero_length_clips(wide_arrays), wide, 8),
    ):
        stream, homology = shift_case(arrays, bcfg)
        max_out = _rev_ops_bound(bcfg.max_ops, bcfg.resolved_max_out())
        cases.append((label, [x.repeat(rep, 1).to(dev) for x in stream],
                      max_out, [x.repeat(rep, 1).to(dev) for x in homology],
                      bcfg.window, int(arrays[2].max())))
    log(f"kernels on reverse-step inputs: plain stage A on the CPU for a "
        f"B=512 primary batch and 64 widest-bucket items in "
        f"{time.perf_counter() - t0:.1f} s")

    results = {"compress_err": 0, "match_run_err": 0}
    for label, (codes, lens), max_out, homology, w, max_n in cases:
        b, k = codes.shape
        got = cleanup_and_compress_cuda(codes, lens, max_out)
        want = cleanup_and_compress_plain(codes, lens, max_out)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"cleanup_and_compress stage-B stream ({label}) "
                f"K={k}: kernel != plain (max abs err {err})")
        results["compress_err"] = max(results["compress_err"], err)
        n_zero = int(((codes != PAD) & (lens == 0)).sum())
        n_tail = int((codes[:, -1] == M).sum())
        ms, pms, times = _timed(
            lambda: cleanup_and_compress_cuda(codes, lens, max_out),
            lambda: cleanup_and_compress_plain(codes, lens, max_out),
        )
        log(f"kernel cleanup_and_compress stage-B stream ({label}, up to "
            f"{max_n} ops) B={b} K={k} max_out={max_out}: equal; "
            f"{n_zero} zero-length non-PAD ops, {n_tail} rows with the "
            f"trailing flush in the partial last chunk, overflow rows "
            f"{int(got[4].sum())}; {times}")
        results[f"compress_stage_b_{label.split()[0]}"] = (k, ms, pms)

        cwin, end_ref, rseq, end_read, limit = homology
        got = match_run_cuda(cwin, end_ref, rseq, end_read, limit, w, True)
        want = match_run_plain(cwin, end_ref, rseq, end_read, limit, w, True)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        require(err == 0, f"match_run stage-A homology ({label}): kernel != "
                f"plain (max abs err {err})")
        results["match_run_err"] = max(results["match_run_err"], err)
        ms, pms, times = _timed(
            lambda: match_run_cuda(cwin, end_ref, rseq, end_read, limit, w, True),
            lambda: match_run_plain(cwin, end_ref, rseq, end_read, limit, w, True),
        )
        live = limit > 0
        log(f"kernel match_run stage-A homology ({label}) B={b} "
            f"C={limit.shape[1]} W={w} L={cwin.shape[1]} backward: equal; "
            f"{int(live.sum())} clusters, limits up to {int(limit.max())} "
            f"({int((limit > w).sum())} above the window), runs at the "
            f"window {int((got >= w).sum())}, mean run "
            f"{float(got[live].float().mean()):.2f}; {times}")
        results[f"match_run_stage_a_{label.split()[0]}"] = (ms, pms)
    return results


def device_genome(n: int, seed: int):
    """A flat uint8 genome of n random ACGT bytes, made on the card."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    genome = torch.empty(n, dtype=torch.uint8, device="cuda")
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device="cuda")
    chunk = 1 << 28
    for s in range(0, n, chunk):
        part = genome[s:s + chunk]
        part.random_(0, 4, generator=gen)
        part.copy_(lut[part.long()])
    return genome


def resident_case(rng, genome, bases, c: int, max_seq: int):
    """Resident window-runs inputs on the card: item bases ``bases``, read
    rows copied from the genome there with 2% mutations, packed; about 5%
    of clusters mixed, plus clusters at the contract's edges (right window
    at -W, left window at the row's end, odd read offsets)."""
    import numpy as np
    import torch

    from portello_tpu_torch.kernels.resident import pack_seq_rows

    n = genome.shape[0]
    b = len(bases)
    dev = genome.device
    g_base = torch.from_numpy(bases).to(dev)
    idx = g_base[:, None] + torch.arange(max_seq, device=dev)
    rows = torch.where(idx < n, genome[idx.clamp(max=n - 1)], ord("N"))
    rows = rows.cpu().numpy()
    del idx
    mut = rng.random(rows.shape) < 0.02
    rows[mut] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(mut.sum()))
    bs = rng.integers(0, max_seq, size=(b, c)).astype(np.int32)
    shift = np.where(rng.random((b, c)) < 0.8, 0, rng.integers(-3, 4, size=(b, c)))
    rs = (bs + shift).astype(np.int32)
    dl = rng.integers(1, 60, size=(b, c)).astype(np.int32)
    il = np.where(rng.random((b, c)) < 0.5, dl,
                  rng.integers(1, 60, size=(b, c))).astype(np.int32)
    mixed = rng.random((b, c)) < 0.05
    bs[:, 0], rs[:, 0], dl[:, 0], il[:, 0] = 0, 0, 0, 0
    bs[:, 1], rs[:, 1] = max_seq, max_seq
    rs[:, 2] = bs[:, 2] | 1
    mixed[:, :3] = True
    host = (pack_seq_rows(rows), bs, rs, dl, il, mixed)
    return (genome, g_base, *(torch.from_numpy(x).to(dev) for x in host))


def phase_window_match(rng):
    """Kernel 3 in both contracts against its plain versions."""
    import numpy as np
    import torch

    from portello_tpu_torch.kernels.window_match import (
        pad_table,
        window_match_runs_cuda,
        window_match_runs_plain,
        window_runs_resident_cuda,
        window_runs_resident_plain,
    )

    dev = torch.device("cuda")
    results = {}
    err = 0
    t0 = time.perf_counter()
    genome = device_genome(GENOME_BYTES, SEED)
    torch.cuda.synchronize()
    n = genome.shape[0]
    log(f"kernel window_match: {n} byte random genome made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    big = rng.integers(2**31, n - 24576, size=512).astype(np.int64)
    big[-64:] = n - rng.integers(1, 200, size=64)
    cases = (
        ("primary bucket", 96, 24576,
         rng.integers(0, n - 24576, size=512).astype(np.int64)),
        ("widest bucket", 512, 65536,
         rng.integers(0, n - 65536, size=512).astype(np.int64)),
        ("bases past 2^31, 64 within 200 B of the genome end", 96, 24576, big),
    )
    for label, c, max_seq, bases in cases:
        args = resident_case(rng, genome, bases, c, max_seq)
        got = window_runs_resident_cuda(*args, W)
        want = window_runs_resident_plain(*args, W)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require(e == 0, f"window_match resident {label}: kernel != plain "
                f"(max abs err {e})")
        err = max(err, e)
        ms, pms, times = _timed(
            lambda: window_runs_resident_cuda(*args, W),
            lambda: window_runs_resident_plain(*args, W),
        )
        mixed = args[-1]
        log(f"kernel window_match resident B=512 C={c} W={W} "
            f"max_seq={max_seq} ({label}; bases {int(bases.min())}.."
            f"{int(bases.max())} of {n}): equal; {int(mixed.sum())} mixed "
            f"clusters, mean raw_r {float(got[0][mixed].float().mean()):.2f}, "
            f"raw_l {float(got[1][mixed].float().mean()):.2f}; {times}")
        if label == "primary bucket":
            results["window_match"] = (ms, pms)
        del args, got, want
    del genome
    torch.cuda.empty_cache()

    for c, length in ((96, 24576), (512, 65536)):
        a, bb, ia, ib, _ = match_case(rng, 512, c, W, length)
        ta = pad_table(torch.from_numpy(a).to(dev), 0xFE)
        tb = pad_table(torch.from_numpy(bb).to(dev), 0xFD)
        tia, tib = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
        got = window_match_runs_cuda(ta, tb, tia, tib, W)
        want = window_match_runs_plain(ta, tb, tia, tib, W)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require(e == 0, f"window_match Pallas contract C={c} L={length}: "
                f"kernel != plain (max abs err {e})")
        err = max(err, e)
        ms, pms, times = _timed(
            lambda: window_match_runs_cuda(ta, tb, tia, tib, W),
            lambda: window_match_runs_plain(ta, tb, tia, tib, W),
        )
        log(f"kernel window_match Pallas contract B=512 C={c} W={W} "
            f"L={length}: equal (mean run_fwd {float(got[0].float().mean()):.2f}"
            f", run_rev {float(got[1].float().mean()):.2f}); {times}")
    results["window_match_err"] = err
    return results


# ---------------------------------------------------------------- phase 4
def _step_times(step, b: int, label: str):
    """Host-clock, CUDA-event and device times of one device step."""
    import torch

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
    dev_ms, how, n_dev = call_ms(step, reps=10)
    log(f"{label}: {ms:.3f} ms/batch (median of {len(samples)}, host "
        f"clock + sync), {ev_ms:.3f} ms (CUDA events), {b / (ms / 1e3):.0f} "
        f"items/s; {how} time {dev_ms:.3f} ms/batch in {n_dev:.0f} device "
        f"kernels and copies, busy share {dev_ms / ms:.3f} of the host-clock "
        f"step")
    return ms


def _equal_fields(got, want, what: str) -> None:
    import torch

    require(set(got) == set(want), f"{what}: output fields differ")
    for key in want:
        g, w = got[key].cpu(), want[key].cpu()
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"{what}: field {key!r} differs")


def hifi_batch(rng):
    """B=512 HiFi items (18 kb) in the primary bucket, as ``rev_batch``'s
    inputs; without ``win_base`` and ``contig_win`` they are ``fwd_batch``'s."""
    from portello_tpu_torch.models.pipeline_model import DEFAULT_BUCKETS
    from portello_tpu_torch.testutil.batchgen import make_item_arrays

    t0 = time.perf_counter()
    arrays = make_item_arrays(rng, 512, DEFAULT_BUCKETS[0], read_len=18000,
                              rev=True)
    log(f"built 512 HiFi items (18 kb, primary bucket) in "
        f"{time.perf_counter() - t0:.1f} s")
    return arrays


def phase_forward(rng, rev_arrays):
    import torch

    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        batch_from_numpy,
        bucket_kwargs,
        fwd_batch,
        fwd_batch_resident,
        resident_batch_from_numpy,
        rev_batch,
        rev_batch_from_numpy,
    )
    from portello_tpu_torch.testutil.batchgen import (
        resident_from_table,
        shift_win_base,
    )

    bcfg = DEFAULT_BUCKETS[0]
    b = 512
    cuda = torch.device("cuda")
    arrays = tuple(rev_arrays[:4]) + tuple(rev_arrays[6:])
    t1 = time.perf_counter()
    g_sb, g_off, packed, genome_np = resident_from_table(
        arrays, GENOME_BYTES, rng
    )
    res_arrays = tuple(arrays[:7]) + (g_sb, g_off, arrays[8], packed)
    base = (g_sb.astype("int64") << 6) | g_off
    log(f"forward: {b} HiFi items placed in a {genome_np.shape[0]} byte "
        f"genome in {time.perf_counter() - t1:.1f} s ({int((base > 2**31).sum())}"
        f" item bases past 2^31, the last at {int(base.max())})")
    kw = bucket_kwargs(bcfg)

    # table slots
    t0 = time.perf_counter()
    want = fwd_batch(*batch_from_numpy(arrays, "cpu"), **kw)
    cpu_s = time.perf_counter() - t0
    table_args = batch_from_numpy(arrays, cuda)
    _cuda.reset_launch_counts()
    table = fwd_batch(*table_args, **kw)
    torch.cuda.synchronize()
    launches = {"table": dict(_cuda.launch_counts)}
    require_launches(launches["table"], "table", "forward table step")
    _equal_fields(table, want, "forward table step CUDA vs CPU")

    # resident slots: the genome goes to the card once
    t0 = time.perf_counter()
    genome = genome_tensor(genome_np, cuda)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_cpu = fwd_batch_resident(
        *resident_batch_from_numpy(res_arrays, "cpu"),
        genome_tensor(genome_np, "cpu"), **kw,
    )
    res_cpu_s = time.perf_counter() - t0
    res_args = resident_batch_from_numpy(res_arrays, cuda)
    _cuda.reset_launch_counts()
    res = fwd_batch_resident(*res_args, genome, **kw)
    torch.cuda.synchronize()
    launches["resident"] = dict(_cuda.launch_counts)
    require_launches(launches["resident"], "resident", "forward resident step")
    _equal_fields(res, table, "forward resident step vs table step (CUDA)")
    _equal_fields(res, res_cpu, "forward resident step CUDA vs CPU")

    # the reverse step, at window base 0 and with half the items at nonzero
    # window bases (each such window cut out of a longer contig)
    t0 = time.perf_counter()
    rev_cpu = rev_batch(*rev_batch_from_numpy(rev_arrays, "cpu"), **kw)
    rev_cpu_s = time.perf_counter() - t0
    rev_args = rev_batch_from_numpy(rev_arrays, cuda)
    _cuda.reset_launch_counts()
    rev = rev_batch(*rev_args, **kw)
    torch.cuda.synchronize()
    launches["rev"] = dict(_cuda.launch_counts)
    require_launches(launches["rev"], "rev", "reverse step")
    _equal_fields(rev, rev_cpu, "reverse step CUDA vs CPU")
    moved_arrays, moved = shift_win_base(rev_arrays, rng)
    moved_cpu = rev_batch(*rev_batch_from_numpy(moved_arrays, "cpu"), **kw)
    moved_out = rev_batch(*rev_batch_from_numpy(moved_arrays, cuda), **kw)
    torch.cuda.synchronize()
    _equal_fields(moved_out, moved_cpu,
                  "reverse step at nonzero window bases CUDA vs CPU")
    keep = ~rev_cpu["fallback"] & ~moved_cpu["fallback"]
    for key in rev_cpu:
        require(torch.equal(rev_cpu[key][keep], moved_cpu[key][keep]),
                f"reverse step: field {key!r} moves with the window base")
    wb = moved_arrays[4]
    log(f"reverse B={b} K_stage_b={2 * bcfg.max_ops + 1} max_out="
        f"{min(bcfg.max_ops, kw['max_out'])}: CUDA == CPU on all "
        f"{len(rev_cpu)} fields at window base 0 and with {int(moved.sum())} "
        f"items at window bases {int(wb[moved].min())}..{int(wb[moved].max())}"
        f"; those equal the base-0 batch on the {int(keep.sum())} items "
        f"neither flags; mapped {int(rev_cpu['mapped'].sum())}, fallback "
        f"{int(rev_cpu['fallback'].sum())} (base 0) and "
        f"{int(moved_cpu['fallback'].sum())} (moved); CPU plain step "
        f"{rev_cpu_s:.2f} s")

    n_fb = int(want["fallback"].sum())
    n_mapped = int(want["mapped"].sum())
    h2d = {"table": sum(t.nbytes for t in table_args),
           "resident": sum(t.nbytes for t in res_args),
           "rev": sum(t.nbytes for t in rev_args)}
    log(f"forward B={b} K_lift={2 * kw['max_rows']} max_out={kw['max_out']}: "
        f"table step CUDA == CPU, resident step CUDA == table step == "
        f"resident CPU on all {len(want)} fields; mapped {n_mapped}, fallback "
        f"{n_fb}; launches per path {json.dumps(launches)}")
    log(f"steps: genome {genome.shape[0] / 2**20:.1f} MiB uploaded in "
        f"{upload_s:.2f} s; H2D per batch: table {h2d['table']} bytes, "
        f"resident {h2d['resident']} bytes, reverse {h2d['rev']} bytes; CPU "
        f"plain steps: table {cpu_s:.2f} s, resident {res_cpu_s:.2f} s")
    steps = {
        "table": lambda: fwd_batch(*table_args, **kw),
        "resident": lambda: fwd_batch_resident(*res_args, genome, **kw),
        "rev": lambda: rev_batch(*rev_args, **kw),
    }
    labels = {"table": "forward table step", "resident": "forward resident step",
              "rev": "reverse step"}
    times = {mode: [] for mode in steps}
    for mode in ("table", "resident", "rev", "rev", "resident", "table"):
        times[mode].append(_step_times(steps[mode], b, labels[mode]))
    log("steps: ms/batch (host clock) " + ", ".join(
        f"{mode} " + " / ".join(f"{t:.3f}" for t in times[mode])
        for mode in steps))
    del genome
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5
_LIFTED = re.compile(
    r"Lifted (\d+) primary reads: (\d+) device work items, (\d+) host items "
    r"\((\d+) window/bucket fallbacks\)"
)
_LAUNCHES = re.compile(r"kernel launches: (\{.*\})")
_TIMING_LINES = ("feed timing:", "native phase split:", "Total Runtime:",
                 "Resident genome:")


def _sam_records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(path) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def _cli(module, d, tag, device, extra=(), env_extra=None):
    env = dict(os.environ, PTPU_FEED_TIMING="1", **(env_extra or {}))
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


_H2D = re.compile(r"H2D per batch: (\d+) bytes \((\w+) slots, (\d+) batches, "
                  r"rev_batches (\d+) of (\d+) bytes\)")
_PYFEED = re.compile(r"Python feed: (\d+) device batches, rev_batches (\d+)")

# The CLI runs of phase 5: (path, --feed, environment).
E2E_RUNS = (
    ("resident", "native", {}),
    ("table", "native", {"PTPU_RESIDENT": "0"}),
    ("native_devshift", "native", {"PTPU_HOST_SHIFT": "0"}),
    ("python", "python", {}),
    ("python_devshift", "python", {"PTPU_HOST_SHIFT": "0"}),
)


def _feed_line(path, feed, err):
    """The feed's own stats line: slot mode and H2D bytes for the native
    feed, device batches for the Python feed; checks that reverse batches
    ran exactly under device-shift routing."""
    devshift = path.endswith("_devshift")
    if feed == "native":
        hm = _H2D.search(err)
        require(hm is not None, f"e2e {path}: no H2D line:\n{err[-3000:]}")
        mode = "resident" if path == "resident" else "table"
        require(hm.group(2) == mode, f"e2e {path} run used {hm.group(2)} slots")
        n_rev = int(hm.group(4))
        text = (f"H2D {hm.group(1)} bytes/batch over {hm.group(3)} batches "
                f"({hm.group(2)} slots), {n_rev} reverse batches of "
                f"{hm.group(5)} bytes")
    else:
        pm = _PYFEED.search(err)
        require(pm is not None, f"e2e {path}: no Python feed line:\n{err[-3000:]}")
        n_rev = int(pm.group(2))
        text = f"{pm.group(1)} device batches, {n_rev} reverse"
    require((n_rev > 0) == devshift,
            f"e2e {path}: {n_rev} reverse batches under "
            f"{'device' if devshift else 'host'}-shift routing")
    return text


def phase_e2e():
    import numpy as np

    from portello_tpu.testutil.simulate import make_scenario

    runs = {}
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as d:
        t0 = time.perf_counter()
        make_scenario(d, rng=np.random.default_rng(99), n_reads_per_contig=400,
                      read_len=18000, chrom_len=200000)
        log(f"e2e: bench scenario (4 contigs x 400 reads x 18 kb) built in "
            f"{time.perf_counter() - t0:.1f} s")
        threads = str(os.cpu_count() or 1)
        host_wall, _ = _cli("portello_tpu.main", d, "host", "host",
                            ("--threads", threads))
        want = {kind: _sam_records(os.path.join(d, f"{kind}_host.bam"))
                for kind in ("remapped", "un")}
        require(len(want["remapped"]) > 0, "e2e produced no remapped records")
        # Each CLI runs in its own process, whose launch counts start at 0;
        # it logs the launches of its phase-2 run ("kernel launches: {...}").
        for path, feed, env in E2E_RUNS:
            wall, err = _cli("portello_tpu_torch.main", d, path, "cuda",
                             ("--feed", feed, "--threads", threads), env)
            m = _LIFTED.search(err)
            lm = _LAUNCHES.search(err)
            require(m is not None and lm is not None,
                    f"port CLI log lacks its stats lines:\n{err[-3000:]}")
            feed_text = _feed_line(path, feed, err)
            launches = json.loads(lm.group(1))
            require_launches(launches, path, f"e2e {path} run")
            for line in err.splitlines():
                if any(k in line for k in _TIMING_LINES):
                    log(f"e2e port CLI ({path}): " + line.split("] ", 1)[-1])
            for kind in ("remapped", "un"):
                got = _sam_records(os.path.join(d, f"{kind}_{path}.bam"))
                require(got == want[kind], f"e2e {path} {kind} records "
                        f"differ from --device host ({len(got)} vs "
                        f"{len(want[kind])} records)")
            n_primary, dev_items, host_items, fb_items = map(int, m.groups())
            log(f"e2e {path} (--feed {feed}{''.join(f' {k}={v}' for k, v in env.items())}"
                f"): --device cuda output == --device host output "
                f"({len(want['remapped'])} remapped records, sorted SAM); "
                f"port CLI wall {wall:.2f} s for {n_primary} primary reads = "
                f"{n_primary / wall:.1f} reads/s (whole process); device "
                f"items {dev_items}, host items {host_items}, fallbacks "
                f"{fb_items}; {feed_text}; launches {json.dumps(launches)}")
            runs[path] = launches
    log(f"e2e: host-path CLI wall {host_wall:.2f} s")
    return runs


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
        rev_arrays = hifi_batch(rng)
        kres = phase_kernels(rng, rev_arrays)
        phase_forward(rng, rev_arrays)
        e2e = phase_e2e()
        require("jax" not in sys.modules, "jax was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    # launches: the main path's run (resident slots) for its kernels, the
    # table-slot run for match_run; launches_by_path: every CLI run's
    kernels = [
        {
            "name": "cleanup_and_compress", "route": "cuda",
            "source": "portello_tpu_torch/csrc/compress.cu",
            "replaces": "portello_tpu/kernels/pallas/compress_pallas.py:124",
            "launches": e2e["resident"]["cleanup_and_compress"],
            "max_abs_err": kres["cleanup_and_compress_err"],
            "ms": kres["cleanup_and_compress"][0],
            "plain_ms": kres["cleanup_and_compress"][1],
        },
        {
            "name": "match_run", "route": "cuda",
            "source": "portello_tpu_torch/csrc/match_run.cu",
            "replaces": "portello_tpu/kernels/pallas/match_run_pallas.py:78",
            "launches": e2e["table"]["match_run"],
            "max_abs_err": kres["match_run_err"],
            "ms": kres["match_run"][0],
            "plain_ms": kres["match_run"][1],
        },
        {
            "name": "window_match", "route": "cuda",
            "source": "portello_tpu_torch/csrc/window_match.cu",
            "replaces": "portello_tpu/kernels/pallas/window_match.py:96",
            "launches": e2e["resident"]["window_match"],
            "max_abs_err": kres["window_match_err"],
            "ms": kres["window_match"][0],
            "plain_ms": kres["window_match"][1],
        },
    ]
    for k in kernels:
        k["launches_by_path"] = {path: e2e[path][k["name"]] for path in e2e}
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
