"""Combination soak of the PyTorch port: one randomized scenario driven
through every production surface of ``python -m portello_tpu_torch.main``,
record-compared against the exact host path.

The port of ``scripts/soak_combo.py``.  Legs: the host path (Python phase
1, the baseline) and the host path with native phase 1; on the device, the
native feed at ``--threads 1 --batch-size 64`` and at ``--threads 4``, on
table slots (``PTPU_RESIDENT=0``) and the Python feed (in place of the JAX
soak's ``PTPU_MM=1`` leg: the port has no one-hot-matmul form); then
``--local-workers 2`` on BAM and on CRAM 3.1, CRAM 2.1 / 3.0 / 3.1 /
3.1-archive inputs, and ``--target-region`` on BAM and CRAM 3.1.  BAM-input
legs must be record-identical to the baseline; CRAM legs identical but for
the ``=``/``X`` -> ``M`` collapse (``io/cram.py``) and unmapped MAPQ; the
region legs are compared among themselves with the host path's region run.

    python scripts/torch_soak_combo.py [n_reads] [read_len] [seed] [--device cuda|cpu]

Prints one line per leg and ``SOAK PASSED``, or exits non-zero.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import numpy as np  # noqa: E402


def main():
    argv = sys.argv[1:]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, not {device!r}")
    n_reads = int(argv[0]) if len(argv) > 0 else 2400
    read_len = int(argv[1]) if len(argv) > 1 else 2000
    seed = int(argv[2]) if len(argv) > 2 else 2026

    from portello_tpu_torch.io.bam import BamReader
    from portello_tpu_torch.testutil.simulate import make_scenario
    from portello_tpu_torch.testutil.spill import sam_records, write_crams

    d = tempfile.mkdtemp(prefix="torch_soak_")
    print(f"scenario dir: {d}; device legs on --device {device}")
    make_scenario(
        d, rng=np.random.default_rng(seed),
        n_reads_per_contig=max(n_reads // 3, 1), read_len=read_len,
        chrom_len=max(8 * read_len, 300000),
        read_snp_rate=0.004, read_indel_rate=0.002,
    )
    bam = os.path.join(d, "read_to_asm.bam")
    crams = write_crams(bam)
    with BamReader(os.path.join(d, "asm_to_ref.bam")) as r:
        chrom = r.header.refs[0][0]
    region = f"{chrom}:1-{6 * read_len}"

    def run(tag, r2a, extra, env=None):
        out = os.path.join(d, f"rem_{tag}.bam")
        un = os.path.join(d, f"un_{tag}.bam")
        cmd = [
            sys.executable, "-m", "portello_tpu_torch.main",
            "--assembly-to-ref", os.path.join(d, "asm_to_ref.bam"),
            "--read-to-assembly", r2a,
            "--remapped-read-output", out,
            "--unassembled-read-output", un,
            "--ref", os.path.join(d, "ref.fa"),
            *extra,
        ]
        e = dict(os.environ)
        e["PYTHONPATH"] = os.path.join(HERE, "..") + os.pathsep + e.get(
            "PYTHONPATH", "")
        e.update(env or {})
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=e, capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout[-2000:])
            print(p.stderr[-2000:])
            raise SystemExit(f"leg {tag} failed rc={p.returncode}")
        lifted = [ln.split("] ")[-1] for ln in p.stderr.splitlines()
                  if "Lifted " in ln or "kernel launches:" in ln]
        print(f"  leg {tag}: {time.perf_counter() - t0:.1f} s; "
              + "; ".join(lifted), flush=True)
        return out, un

    dev = ["--device", device]
    native = dev + ["--feed", "native"]
    legs = {}
    legs["baseline"] = run("baseline", bam, ["--device", "host"],
                           {"PTPU_P1_NATIVE": "0"})
    legs["host-natp1"] = run("host-natp1", bam, ["--device", "host"])
    legs["native-t1"] = run("native-t1", bam,
                            native + ["--threads", "1", "--batch-size", "64"])
    legs["native-t4"] = run("native-t4", bam, native + ["--threads", "4"])
    legs["native-table"] = run("native-table", bam, native + ["--threads", "4"],
                               {"PTPU_RESIDENT": "0"})
    # the JAX soak's PTPU_MM=1 leg: the port has no one-hot-matmul form, so
    # the Python feed runs its one (gather) form here
    legs["python"] = run("python", bam, dev + ["--feed", "python"])
    legs["workers2"] = run("workers2", bam, native + ["--local-workers", "2"])
    legs["workers2-cram"] = run("workers2-cram", crams["31"],
                                native + ["--local-workers", "2"])
    for tag in ("21", "30", "31", "arch"):
        legs[f"cram-{tag}"] = run(f"cram-{tag}", crams[tag], native)
    legs["region-bam"] = run(
        "region-bam", bam, ["--device", "host", "--target-region", region],
        {"PTPU_P1_NATIVE": "0"},
    )
    legs["region-bam-nat"] = run("region-bam-nat", bam,
                                 native + ["--target-region", region])
    legs["region-cram"] = run("region-cram", crams["31"],
                              native + ["--target-region", region])

    base_rem = sam_records(legs["baseline"][0])
    base_un = sam_records(legs["baseline"][1], zero_unmapped_mapq=True)
    base_rem_cx = sam_records(legs["baseline"][0], collapse_eqx=True)
    failures = []
    for tag, (out, un) in legs.items():
        if tag == "baseline" or tag.startswith("region"):
            continue
        is_cram = "cram" in tag
        got_rem = sam_records(out, collapse_eqx=is_cram)
        got_un = sam_records(un, zero_unmapped_mapq=True)
        want_rem = base_rem_cx if is_cram else base_rem
        ok = got_rem == want_rem and got_un == base_un
        print(f"{tag:16s} rem={len(got_rem)} un={len(got_un)} "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            failures.append(tag)
    # region legs compare among themselves (another universe than full runs)
    reg_base = sam_records(legs["region-bam"][0])
    for tag in ("region-bam-nat", "region-cram"):
        is_cram = "cram" in tag
        got = sam_records(legs[tag][0], collapse_eqx=is_cram)
        want = sam_records(legs["region-bam"][0], collapse_eqx=is_cram)
        ok = got == want
        print(f"{tag:16s} rem={len(got)} {'OK' if ok else 'MISMATCH'}")
        if not ok:
            failures.append(tag)
    print(f"region reads: {len(reg_base)} of {len(base_rem)}")
    if failures:
        raise SystemExit(f"SOAK FAILURES: {failures} (outputs in {d})")
    shutil.rmtree(d, ignore_errors=True)
    print("SOAK PASSED")


if __name__ == "__main__":
    main()
