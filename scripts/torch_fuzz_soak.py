"""Randomized differential-fuzz soak of the PyTorch port.

The port of ``scripts/fuzz_soak.py``: a stream of fresh seeds for as long
as asked.  By default each seed runs through the port's ``fwd_batch``,
``fwd_batch_resident`` and ``rev_batch`` on the chosen device:

- at the hostile edit rates and small bucket of
  ``tests/test_fuzz_conformance.py`` (``testutil/spill.hostile_rounds``):
  every unflagged item equal to the numpy oracle and to the exact C++ core
  (``ops/native_core.py``);
- at each of ``DEFAULT_BUCKETS`` (primary, mid and wide;
  ``testutil/spill.spill_batch``, ``B_PER_BUCKET`` items a bucket): every
  unflagged item equal to the C++ core;
- encode-decode rounds of the CRAM 3.1 codecs (rANS Nx16, arithmetic
  Nx16, fqzcomp, tok3).

With ``--scenario`` each seed instead builds a fresh scenario and runs the
whole CLI on it, ``--device cuda|cpu --feed native`` against the exact
``--device host`` path, and the sorted records must be equal.  A third of
the rounds take ``make_scenario`` with the random read lengths and rates of
``fuzz_soak.py``; a third the WGS-shaped ``spill.build_scenario`` at a few
hundred 2-60 kb reads, so that the feed switches between the three
buckets and ends on partial batches in each; a third the fixed fallback
reads of ``spill.build_inputs``, whose read past every bucket goes to the
host and whose saturated shift window is flagged under
``PTPU_HOST_SHIFT=0`` and comes back through the host finisher (flagged
items are rare in random scenarios).  Each round draws the batch size, the
thread count and the routing (resident slots, table slots or
``PTPU_HOST_SHIFT=0``).

A failure prints ``FUZZ FAILURE at seed=N`` and exits non-zero, so the case
can be pinned into the tests.

    python scripts/torch_fuzz_soak.py [minutes] [--device cuda|cpu] [--scenario]

Defaults: 10 minutes and ``cuda`` (the run fails where there is none).
"""

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

# items in each bucket and round of ``bucket_round``
B_PER_BUCKET = 64
# the routings a scenario round draws from: extra environment of the CLI
ROUTINGS = ({}, {"PTPU_RESIDENT": "0"}, {"PTPU_HOST_SHIFT": "0"})


def codec_round(seed: int) -> None:
    """Fresh-seed encode -> decode round trips over every CRAM 3.1 codec."""
    from portello_tpu_torch.io import arith_nx16, fqzcomp, rans_nx16, tok3

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 4000))
    # a skewed alphabet exercises the frequency tables harder than uniform
    alpha = rng.integers(2, 40)
    data = rng.integers(0, alpha, size=n).astype(np.uint8).tobytes()
    for order in (0, 1):
        assert rans_nx16.decode(rans_nx16.encode(data, order=order)) == data
        assert arith_nx16.decode(arith_nx16.encode(data, order=order)) == data
    quals = rng.integers(0, 45, size=n).astype(np.uint8).tobytes()
    lens = []
    left = n
    while left > 0:
        take = int(min(left, rng.integers(1, 400)))
        lens.append(take)
        left -= take
    assert fqzcomp.decode(fqzcomp.encode(quals, lens), n_out=n) == quals
    names = b"".join(
        f"read{int(rng.integers(0, 10**6))}/{int(rng.integers(1, 3))}\x00"
        .encode()
        for _ in range(int(rng.integers(1, 200)))
    )
    assert tok3.decode(tok3.encode(names)) == names


def bucket_round(seed: int, device, pool, counters) -> None:
    """``B_PER_BUCKET`` items in each of ``DEFAULT_BUCKETS`` through the three steps,
    each unflagged item against the exact C++ core."""
    from portello_tpu_torch.models.pipeline_model import (
        DEFAULT_BUCKETS,
        bucket_kwargs,
    )
    from portello_tpu_torch.testutil import spill

    for bucket, bcfg in enumerate(DEFAULT_BUCKETS):
        rev_args = spill.spill_batch(seed + bucket, B_PER_BUCKET, bucket,
                                     chunk=B_PER_BUCKET // 8, executor=pool)
        fwd_args = spill.fwd_of_rev(rev_args)
        kw = bucket_kwargs(bcfg)
        outs = spill.run_steps(fwd_args, rev_args, device, kw)
        for name, out in outs.items():
            spill.check_native(
                out, rev_args if name == "rev" else fwd_args, kw["max_out"],
                counters[bucket], rev=name == "rev",
                what=f"seed {seed} bucket {bucket} {name}")


def scenario_round(seed: int, device: str) -> str:
    """A fresh scenario through the whole CLI on the native feed against
    the exact host path; returns what the round drew."""
    import shutil
    import tempfile

    from portello_tpu_torch.main import main
    from portello_tpu_torch.pipeline import native_feed
    from portello_tpu_torch.testutil import spill
    from portello_tpu_torch.testutil.simulate import make_scenario

    rng = np.random.default_rng(seed)
    work = tempfile.mkdtemp(prefix="fuzz_scn_")
    try:
        kind = ("make_scenario", "wgs-shaped", "fallback reads")[
            int(rng.integers(0, 3))]
        inputs = [os.path.join(work, name)
                  for name in ("asm_to_ref.bam", "read_to_asm.bam", "ref.fa")]
        if kind == "make_scenario":
            make_scenario(
                work, rng=rng,
                n_reads_per_contig=int(rng.integers(10, 80)),
                read_len=int(rng.integers(150, 2500)),
                read_snp_rate=float(rng.uniform(0.0005, 0.02)),
                read_indel_rate=float(rng.uniform(0.0005, 0.02)),
            )
        elif kind == "wgs-shaped":
            spill.build_scenario(work, int(rng.integers(50, 400)), rng)
        else:
            inputs = spill.build_inputs(work)
        env = ROUTINGS[int(rng.integers(0, len(ROUTINGS)))]
        batch = int(rng.integers(16, 65))
        threads = int(rng.integers(1, 5))

        def run(tag, dev):
            out = os.path.join(work, f"rem_{tag}.bam")
            un = os.path.join(work, f"un_{tag}.bam")
            main([
                "--assembly-to-ref", inputs[0],
                "--read-to-assembly", inputs[1],
                "--remapped-read-output", out,
                "--unassembled-read-output", un,
                "--ref", inputs[2],
                "--device", dev, "--feed", "native" if dev != "host" else "python",
                "--batch-size", str(batch), "--threads", str(threads),
            ])
            return out, un

        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out_n, un_n = run("native", device)
            st = native_feed._last_stats
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out_h, un_h = run("host", "host")
        assert spill.sam_records(out_n) == spill.sam_records(out_h), \
            "native feed diverged from the host path"
        assert spill.sam_records(un_n) == spill.sam_records(un_h)
        return (f"{kind} {env or 'resident'} batch {batch} threads {threads}: "
                f"batches per bucket {st['batches_per_bucket']}, host items "
                f"{st['host_items']}, fallback items {st['fallback_items']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("minutes", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenario", action="store_true",
                    help="whole-CLI rounds against the host path")
    args = ap.parse_args()

    import torch

    from portello_tpu_torch.kernels import _cuda
    from portello_tpu_torch.testutil import spill

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; pass --device cpu for a "
              "CPU run", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(0) if device.type == "cuda"
             else "cpu (plain PyTorch versions of the kernels)")
    print(f"[torch_fuzz_soak] device {where}", flush=True)

    # the cluster-overflow item must flag, its neighbours stay exact
    from portello_tpu_torch.models.pipeline_model import (
        batch_from_numpy,
        fwd_batch,
    )

    ovf = spill.cluster_overflow_batch()
    out = fwd_batch(*batch_from_numpy(ovf, device), **spill.KW)
    c = spill.new_counters()
    spill.check_batch(out, ovf, spill.expect_fwd, c, "cluster overflow")
    if not bool(out["fallback"][0]) or not c["exact"]:
        print(f"FUZZ FAILURE: cluster-overflow item not flagged ({c})")
        return 1

    deadline = time.time() + args.minutes * 60
    master = np.random.default_rng(int(time.time()) % (2**31))
    hostile = spill.new_counters()
    buckets = [spill.new_counters() for _ in range(3)]
    rounds = 0
    t0 = time.time()
    _cuda.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        pool = None if args.scenario else stack.enter_context(spill.item_pool())
        while time.time() < deadline:
            seed = int(master.integers(0, 2**31 - 1))
            try:
                if args.scenario:
                    drew = scenario_round(seed, args.device)
                    print(f"[torch_fuzz_soak] seed {seed} clean: {drew}",
                          flush=True)
                else:
                    spill.hostile_rounds(seed, device, hostile)
                    bucket_round(seed, device, pool, buckets)
                    codec_round(seed)
            except AssertionError:
                print(f"FUZZ FAILURE at seed={seed}", flush=True)
                raise
            rounds += 1
            if rounds % 5 == 0:
                print(f"[torch_fuzz_soak] {rounds} seed-rounds clean "
                      f"({time.time() - t0:.0f}s)", flush=True)
    if not args.scenario:
        print(f"[torch_fuzz_soak] hostile small bucket {hostile}; by bucket "
              + "; ".join(f"{i}: {c}" for i, c in enumerate(buckets)))
    print(f"[torch_fuzz_soak] kernel launches {dict(_cuda.launch_counts)}")
    kind = "scenario" if args.scenario else "kernel/codec"
    print(f"FUZZ SOAK CLEAN: {rounds} fresh-seed {kind} rounds over "
          f"{time.time() - t0:.0f}s on {where}")
    return 0

if __name__ == "__main__":
    sys.exit(main())
