"""The PyTorch port never imports jax: the machine with the GPU has none.

Runs in a fresh interpreter: imports every module of the port and
``chip_smoke``, runs a small forward step in each slot mode, a small reverse
step, and small CLI runs on the CPU on the native feed and on the Python
feed under device-shift routing, then checks ``sys.modules``."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = textwrap.dedent(
    """
    import os, sys, tempfile
    import numpy as np
    import chip_smoke
    import portello_tpu_torch
    import portello_tpu_torch.kernels._cuda
    import portello_tpu_torch.kernels.cigar_kernels
    import portello_tpu_torch.kernels.cluster_utils
    import portello_tpu_torch.kernels.liftover_parallel
    import portello_tpu_torch.kernels.resident
    import portello_tpu_torch.kernels.shift_kernel
    import portello_tpu_torch.kernels.simplify_kernel
    import portello_tpu_torch.kernels.window_match
    import portello_tpu_torch.main
    import portello_tpu_torch.pipeline.native_feed
    from portello_tpu_torch.kernels.resident import genome_tensor
    from portello_tpu_torch.models.batch import BucketConfig
    from portello_tpu_torch.models.pipeline_model import (
        DeviceEngine, batch_from_numpy, bucket_kwargs, fwd_batch,
        fwd_batch_resident, resident_batch_from_numpy, rev_batch,
        rev_batch_from_numpy)
    from portello_tpu_torch.testutil.batchgen import (
        make_item_arrays, resident_from_table, shift_win_base)
    from portello_tpu.testutil.simulate import make_scenario

    bcfg = BucketConfig(max_ops=32, max_blocks=16, max_seq=2048,
                        max_clusters=24, window=48)
    arrays = make_item_arrays(np.random.default_rng(0), 4, bcfg, read_len=800)
    out = fwd_batch(*batch_from_numpy(arrays, "cpu"), **bucket_kwargs(bcfg))
    assert bool(out["mapped"].all())
    g_sb, g_off, packed, genome = resident_from_table(arrays)
    res = tuple(arrays[:7]) + (g_sb, g_off, arrays[8], packed)
    res_out = fwd_batch_resident(
        *resident_batch_from_numpy(res, "cpu"), genome_tensor(genome, "cpu"),
        **bucket_kwargs(bcfg))
    assert all(bool((res_out[k] == out[k]).all()) for k in out)
    rng = np.random.default_rng(1)
    rev, _ = shift_win_base(make_item_arrays(rng, 4, bcfg, read_len=800,
                                             rev=True), rng)
    rev_out = rev_batch(*rev_batch_from_numpy(rev, "cpu"), **bucket_kwargs(bcfg))
    assert bool(rev_out["mapped"].all())
    with tempfile.TemporaryDirectory() as d:
        make_scenario(d, rng=np.random.default_rng(2), n_reads_per_contig=5,
                      read_len=300)
        for feed, host_shift in (("native", "1"), ("python", "0")):
            os.environ["PTPU_HOST_SHIFT"] = host_shift
            portello_tpu_torch.main.main([
                "--assembly-to-ref", d + "/asm_to_ref.bam",
                "--read-to-assembly", d + "/read_to_asm.bam",
                "--remapped-read-output", d + "/out.bam",
                "--unassembled-read-output", d + "/un.bam",
                "--ref", d + "/ref.fa", "--device", "cpu", "--batch-size", "16",
                "--feed", feed,
            ])
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    print("JAX_MODULES", leaked)
    assert not leaked, leaked
    """
)


def test_port_imports_no_jax():
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-c", PROGRAM], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-3000:]
    assert "JAX_MODULES []" in p.stdout
