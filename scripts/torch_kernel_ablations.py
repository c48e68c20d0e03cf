#!/usr/bin/env python3
"""Where the time of the port's kernels 1 and 3 goes, on one CUDA GPU.

    python3 scripts/torch_kernel_ablations.py

Builds variants of ``portello_tpu_torch/csrc/compress.cu`` and
``window_match.cu`` that each leave out one part of the work (the variants'
outputs are wrong by design, so nothing is compared), and prints the device
time per call of each from ``torch.profiler``, at ``chip_smoke.py``'s
main-path shapes and inputs:

- kernel 3 (resident window runs, B=512, C=96 and 512): as built (4 mixed
  pairs per load round); without the window loads (the floor: launch, the
  mask and arguments, the stores); without the genome loads; without the
  packed read loads; with 2 and 8 pairs per load round;
- kernel 1 (cleanup + compress, B=512): as built (4 warps per item, one
  item per block), with 1 and 2 warps per item, with 2 and 4 items per
  block, and with only the staging and the stores (no scan);
- the launch floor: ``fill_`` of 512 int32 on the card.

The card's name and power limit are printed first.  Needs one card, nvcc
and the repo on the path; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from portello_tpu_torch.kernels import _cuda  # noqa: E402

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def variant(source: str, edits: dict) -> str:
    """``source`` with each old -> new edit applied exactly once."""
    for old, new in edits.items():
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source


def build(d: str, name: str, source: str):
    path = os.path.join(d, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    so = os.path.join(d, f"{name}.so")
    p = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC,
                        "-shared", "-o", so, path],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{p.stderr[-3000:]}")
    return ctypes.CDLL(so, mode=ctypes.RTLD_LOCAL)


def us(fn) -> str:
    return f"{cs.call_ms(fn)[0] * 1e3:.2f} us"


def window_variants(d: str) -> dict:
    with open(os.path.join(_cuda.CSRC, "window_match.cu")) as f:
        src = f.read()
    loads = {
        "genome": ("v[g][0] = p.ref_r(t0);", "v[g][2] = p.ref_l(t0);",
                   "v[g][4] = p.ref_r(t1);", "v[g][6] = p.ref_l(t1);"),
        "read": ("v[g][1] = p.read_r.raw(t0);", "v[g][3] = p.read_l.raw(t0);",
                 "v[g][5] = p.read_r.raw(t1);", "v[g][7] = p.read_l.raw(t1);"),
    }
    sources = {
        "as built": src,
        "no window loads": variant(src, {
            "  while (todo) {  // warp-uniform":
            "  todo = 0;\n  while (todo) {  // warp-uniform"}),
        # a constant 'A' byte, and a packed byte that decodes to 'A'
        "no genome loads": variant(src, {
            s: s.split("=")[0] + "= 65;" for s in loads["genome"]}),
        "no read loads": variant(src, {
            s: s.split("=")[0] + "= 0x11;" for s in loads["read"]}),
        "2 pairs per load round": variant(src, {
            "constexpr int kGroup = 4;": "constexpr int kGroup = 2;"}),
        "8 pairs per load round": variant(src, {
            "constexpr int kGroup = 4;": "constexpr int kGroup = 8;"}),
    }
    libs = {}
    for i, (name, source) in enumerate(sources.items()):
        lib = build(d, f"window{i}", source)
        lib.ptt_window_runs_resident.restype = I
        lib.ptt_window_runs_resident.argtypes = [
            P, LL, P, P, I, P, P, P, P, P, I, I, I, P, P, P]
        libs[name] = lib
    return libs


def compress_variants(d: str) -> dict:
    with open(os.path.join(_cuda.CSRC, "compress.cu")) as f:
        src = f.read()
    warps = "constexpr int kWarpsPerItem = 4;"
    sources = {
        "as built": src,
        "1 warp per item": variant(src, {warps: warps.replace("4", "1")}),
        "2 warps per item": variant(src, {warps: warps.replace("4", "2")}),
        "2 items per block": variant(src, {
            "constexpr int kThreads = 128;": "constexpr int kThreads = 256;"}),
        "4 items per block": variant(src, {
            "constexpr int kThreads = 128;": "constexpr int kThreads = 512;"}),
        "staging and stores only": variant(src, {
            "const int kk = live ? k : 0;": "const int kk = 0;"}),
    }
    libs = {}
    for i, (name, source) in enumerate(sources.items()):
        lib = build(d, f"compress{i}", source)
        lib.ptt_cleanup_and_compress.restype = I
        lib.ptt_cleanup_and_compress.argtypes = [P, P, I, I, I, P, P, P, P,
                                                 P, P]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="ptt_ablate_") as d:
        wlibs = window_variants(d)
        clibs = compress_variants(d)
        genome = cs.device_genome(cs.GENOME_BYTES, cs.SEED)
        n = genome.shape[0]
        for c, max_seq in ((96, 24576), (512, 65536)):
            bases = rng.integers(0, n - max_seq, size=512).astype(np.int64)
            g, gb, packed, bs, rs, dl, il, mixed = cs.resident_case(
                rng, genome, bases, c, max_seq)
            b = packed.shape[0]
            rr = torch.empty((b, c), dtype=torch.int32, device="cuda")
            rl = torch.empty_like(rr)
            row = []
            for name, lib in wlibs.items():
                def run(lib=lib):
                    rc = lib.ptt_window_runs_resident(
                        g.data_ptr(), n, gb.data_ptr(), packed.data_ptr(),
                        packed.shape[1], bs.data_ptr(), rs.data_ptr(),
                        dl.data_ptr(), il.data_ptr(), mixed.data_ptr(), b, c,
                        cs.W, rr.data_ptr(), rl.data_ptr(), stream())
                    assert rc == 0, rc
                row.append(f"{name} {us(run)}")
            print(f"kernel 3 resident B=512 C={c} ({int(mixed.sum())} mixed): "
                  + "; ".join(row), flush=True)
        del genome
        torch.cuda.empty_cache()
        for k, max_out in ((352, 232), (464, 232), (2816, 1800), (3600, 1800),
                           (257, 128), (2049, 1024)):
            codes, lens = cs.compress_case(rng, 512, k)
            ct = torch.from_numpy(codes).cuda()
            lt = torch.from_numpy(lens).cuda()
            oc = torch.empty((512, max_out), dtype=torch.int32, device="cuda")
            ol = torch.empty_like(oc)
            no = torch.empty(512, dtype=torch.int32, device="cuda")
            sh = torch.empty_like(no)
            ov = torch.empty(512, dtype=torch.bool, device="cuda")
            row = []
            for name, lib in clibs.items():
                def run(lib=lib):
                    rc = lib.ptt_cleanup_and_compress(
                        ct.data_ptr(), lt.data_ptr(), 512, k, max_out,
                        oc.data_ptr(), ol.data_ptr(), no.data_ptr(),
                        sh.data_ptr(), ov.data_ptr(), stream())
                    assert rc == 0, rc
                row.append(f"{name} {us(run)}")
            print(f"kernel 1 B=512 K={k} max_out={max_out}: " + "; ".join(row),
                  flush=True)
    z = torch.empty(512, dtype=torch.int32, device="cuda")
    print(f"launch floor: fill_ of 512 int32 {us(lambda: z.fill_(1))}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
