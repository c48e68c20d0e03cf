"""Command-line entry point of the PyTorch port: ``python -m portello_tpu_torch.main``.

The same flags and exit codes as ``portello_tpu.main`` (whose parser and
validation are copied into ``cli.py``), except ``--device``:

- ``cuda`` (default): the device steps on the GPU, through the hand-written
  kernels.  With no CUDA device the run exits non-zero; it never falls back.
- ``cpu``: the same steps with the kernels' plain PyTorch versions.
- ``host``: the exact host oracle path (``read_scan.scan_and_remap_reads``).

Phase 2 runs on the native C++ feed (``--feed native``, or ``auto`` when the
scanner builds), in resident slot mode (the genome stays on the device;
``PTPU_RESIDENT=0`` selects table slots instead, as in ``portello_tpu``), or
on the Python feed (``--feed python``, or ``auto`` when the scanner does
not build): the shared ``read_scan.scan_and_remap_reads`` driving the port's
``DeviceEngine``.  ``PTPU_HOST_SHIFT=0`` selects device-shift routing on
either feed: reverse-contig items run the reverse step ``rev_batch``.

Scale-out, on every ``--device``: ``--num-hosts N --host-id H`` lifts only
host H's contig shard into ``out.shardHHofNN.bam`` (``--coordinator
host:port`` adds a ``torch.distributed`` rendezvous over gloo);
``--local-workers N`` runs N such shards as processes on this machine and
merges them.  ``--profile DIR`` traces phase 2 with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

from portello_tpu_torch._version import PROGRAM_NAME, PROGRAM_VERSION
from portello_tpu_torch.cli import (
    EX_DATAERR,
    Settings,
    build_parser as _base_build_parser,
    validate_and_fix_settings,
    validate_settings_data,
)
from portello_tpu_torch.io.fasta import get_genome_ref_from_fasta
from portello_tpu_torch.logger import setup_logger
from portello_tpu_torch.parallel.distributed import (
    plan_host_shards,
    shard_output_path,
)
from portello_tpu_torch.pipeline.contig_scan import scan_contig_bam
from portello_tpu_torch.utils.chrom_list import ChromList
from portello_tpu_torch.utils.genome_segment import GenomeSegment
from portello_tpu_torch.utils.spans import CallSpans, add_to_chrome_trace

DEVICES = ("cuda", "cpu", "host")

_HELP = {
    "device": "Compute path: cuda (GPU kernels), cpu (plain PyTorch) or host "
    "(exact host oracle)",
    "profile": "Trace phase 2 with torch.profiler: write a Chrome trace, "
    "with the run's own spans on one row per thread role, and an op table "
    "sorted by device time to DIR, and log per-stage feed timing",
    "coordinator": "Rendezvous address (host:port, served by host 0) for a "
    "multi-host run over torch.distributed (gloo); omit for independent "
    "per-host runs",
}


def get_chrom_array(ref_filename: str, ref_chrom_list: ChromList, logger) -> list[np.ndarray]:
    """Reference FASTA as an array ordered by ref chrom index, with name/length
    consistency checks (main.rs:24-62; exit DATAERR on mismatch)."""
    genome = get_genome_ref_from_fasta(ref_filename)
    out = []
    error = False
    for info in ref_chrom_list.data:
        seq = genome.chroms.pop(info.label, None)
        if seq is None:
            logger.error(
                f'Chromosome "{info.label}" specified in the assembly-to-ref '
                "alignment file, but not in the reference fasta"
            )
            error = True
        elif len(seq) != info.length:
            logger.error(
                f'Chromosome "{info.label}" specified with inconsistent length: '
                f"{info.length} in the assembly-to-ref alignment file, and "
                f"{len(seq)} in the reference fasta"
            )
            error = True
        else:
            out.append(seq)
    if error:
        logger.error("Exiting due to one or more reference consistency issues")
        sys.exit(EX_DATAERR)
    return out


def build_parser():
    """The parser of ``cli.py`` with the port's ``--device`` choices."""
    p = _base_build_parser()
    for action in p._actions:
        if action.dest == "device":
            action.choices = list(DEVICES)
            action.default = "cuda"
        if action.dest in _HELP:
            action.help = _HELP[action.dest]
    return p


def parse_settings(argv=None) -> Settings:
    return Settings(**vars(build_parser().parse_args(argv)))


def select_device(settings: Settings):
    """The torch device for ``--device``; None for the host path."""
    if settings.device == "host":
        return None
    import torch

    if settings.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                "--device cuda requested but no CUDA device is available"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def _profiled(settings: Settings, device, logger, spans: CallSpans):
    """``torch.profiler`` over the block when ``--profile DIR`` is given.

    On exit it writes a Chrome trace, with the call's ``spans`` added on
    the profiler's clock (those still open end at the export), and an op
    table sorted by device time (CPU time on the CPU) into DIR, both named
    per host, and logs the top rows.  The profiler keeps every event in
    memory until then.  Where it cannot start, the run goes on untraced
    with a warning."""
    if not settings.profile:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(settings.profile, exist_ok=True)
    on_cuda = device is not None and device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:
        logger.warning(f"profiler unavailable: {e}")
        yield
        return
    try:
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
    finally:
        prof.stop()

    def out(name):
        return shard_output_path(
            os.path.join(settings.profile, name), settings.host_id,
            settings.num_hosts,
        )

    trace = out("trace.json")
    prof.export_chrome_trace(trace)
    add_to_chrome_trace(trace, spans)
    sort_by = "self_device_time_total" if on_cuda else "self_cpu_time_total"
    averages = prof.key_averages()
    with open(out("ops.txt"), "w") as f:
        f.write(averages.table(sort_by=sort_by, row_limit=-1))
    logger.info(f"Wrote profiler trace {trace} and op table {out('ops.txt')}")
    logger.info(
        f"profile: top ops by {sort_by}\n"
        + averages.table(sort_by=sort_by, row_limit=10)
    )


def run(settings: Settings, preloaded_reference=None) -> None:
    """One pipeline run: phase 1, then phase 2 over this host's shard.

    ``preloaded_reference``: the reference FASTA already parsed by a parent
    that forked this worker.  The run's spans (``utils.spans``: the root
    ``call`` and its phases ``startup``, then on the native feed ``feed``
    and ``finish``) and its main thread's CPU seconds reach the native
    feed's stats."""
    spans = CallSpans("call")
    spans.phase("startup")
    logger = setup_logger()
    cmdline = " ".join(sys.argv)
    logger.info(f"Starting {PROGRAM_NAME} {PROGRAM_VERSION} (PyTorch port)")
    logger.info(f"cmdline: {cmdline}")
    logger.info(f"Running on {settings.thread_count} threads")
    start = time.monotonic()

    grouped = False
    if settings.num_hosts > 1 and settings.coordinator:
        from portello_tpu_torch.parallel.distributed import init_distributed

        grouped = init_distributed(
            settings.coordinator, settings.num_hosts, settings.host_id
        )
    try:
        _lift(settings, preloaded_reference, cmdline, logger, spans)
    finally:
        if grouped:
            import torch.distributed as dist

            dist.destroy_process_group()

    elapsed = time.monotonic() - start
    hh = int(elapsed // 3600)
    mm = int(elapsed % 3600 // 60)
    ss = elapsed % 60
    logger.info(
        f"{PROGRAM_NAME} completed. Total Runtime: {hh:02d}:{mm:02d}:{ss:06.3f}"
    )
    spans.close_all()


def _lift(settings: Settings, preloaded_reference, cmdline: str, logger,
          spans: CallSpans) -> None:
    device = select_device(settings)
    use_native_feed = False
    if device is not None:
        from portello_tpu_torch.pipeline.native_feed import build_error, get_lib

        if settings.feed in ("auto", "native"):
            if get_lib() is not None:
                use_native_feed = True
            elif settings.feed == "native":
                raise SystemExit(
                    "--feed native needs the native scanner, which is "
                    f"unavailable: {build_error()}"
                )
            else:
                logger.info(
                    f"native scanner unavailable ({build_error()}): --feed "
                    "auto runs the Python feed"
                )
        logger.info(f"torch device: {device}")

    with spans.span("startup.chrom_lists"):
        ref_chrom_list = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
        assembly_contig_list = ChromList.from_bam_filename(
            settings.read_to_assembly_bam)
        target_region = None
        if settings.target_region is not None:
            target_region = GenomeSegment.from_region_str(
                ref_chrom_list, settings.target_region
            )
    reference = (
        preloaded_reference
        if preloaded_reference is not None
        else get_chrom_array(settings.ref_filename, ref_chrom_list, logger)
    )

    from portello_tpu_torch.pipeline.contig_scan import (
        load_contig_index,
        save_contig_index,
    )

    with spans.span("startup.contig_index"):
        if settings.contig_index and os.path.exists(settings.contig_index):
            all_contig_mapping_info = load_contig_index(
                settings.contig_index, ref_chrom_list, assembly_contig_list,
                target_region, settings.max_join_gap,
            )
            logger.info(f"Loaded contig mapping index from {settings.contig_index}")
        else:
            all_contig_mapping_info = scan_contig_bam(
                settings.assembly_to_ref_bam,
                ref_chrom_list,
                assembly_contig_list,
                target_region,
                max_join_gap=settings.max_join_gap,
                reference_seqs=reference,
                thread_count=settings.thread_count,
            )
            if settings.contig_index:
                save_contig_index(
                    settings.contig_index, all_contig_mapping_info,
                    ref_chrom_list, assembly_contig_list, target_region,
                    settings.max_join_gap,
                )
                logger.info(f"Saved contig mapping index to {settings.contig_index}")

    shard_plan = None
    remapped_out = settings.remapped_read_output
    unassembled_out = settings.unassembled_read_output
    if settings.num_hosts > 1:
        shard_plan = plan_host_shards(
            [c.length for c in assembly_contig_list.data],
            settings.num_hosts,
            settings.host_id,
        )
        remapped_out = shard_output_path(
            remapped_out, settings.host_id, settings.num_hosts
        )
        unassembled_out = shard_output_path(
            unassembled_out, settings.host_id, settings.num_hosts
        )
        logger.info(
            f"Host {settings.host_id}/{settings.num_hosts} owns "
            f"{len(shard_plan.contig_indices)} contigs; output shard: "
            f"{remapped_out}"
        )

    with _profiled(settings, device, logger, spans):
        if device is None or not use_native_feed:
            from portello_tpu_torch.pipeline.read_scan import scan_and_remap_reads

            engine = None
            if device is not None:
                from portello_tpu_torch.models.pipeline_model import DeviceEngine

                engine = DeviceEngine(
                    reference, assembly_contig_list, all_contig_mapping_info,
                    device, batch_size=settings.batch_size,
                )
            scan_and_remap_reads(
                settings.read_to_assembly_bam,
                remapped_out,
                unassembled_out,
                reference,
                ref_chrom_list,
                all_contig_mapping_info,
                target_region is not None,
                cmdline=cmdline,
                engine=engine,
                thread_count=settings.thread_count,
                shard_plan=shard_plan,
            )
            if engine is not None:
                from portello_tpu_torch.models.compiled import compiled_steps_line

                stats = engine.stats
                logger.info(
                    f"Python feed: {stats['batches']} device batches, "
                    f"rev_batches {stats['rev_batches']} "
                    f"({'host' if engine.host_shift else 'device'}-shift "
                    "routing); groups by kind/bucket/rows: " + ", ".join(
                        f"{k} x{n}" for k, n in sorted(stats["groups"].items()))
                )
                logger.info(compiled_steps_line(stats, [engine.device],
                                                stats["batches"]))
                logger.info(
                    f"kernel launches: {json.dumps(stats['kernel_launches'])}"
                )
        else:
            from portello_tpu_torch.io.aln_input import is_cram_file
            from portello_tpu_torch.pipeline.native_feed import (
                scan_and_remap_reads_native,
            )

            cram_reference = None
            if is_cram_file(settings.read_to_assembly_bam):
                cram_reference = {
                    c.label: seq for c, seq in zip(ref_chrom_list.data, reference)
                }
            stats = scan_and_remap_reads_native(
                settings.read_to_assembly_bam,
                remapped_out,
                unassembled_out,
                reference,
                ref_chrom_list,
                all_contig_mapping_info,
                target_region is not None,
                device,
                cmdline=cmdline,
                batch_size=settings.batch_size,
                thread_count=settings.thread_count,
                cram_reference=cram_reference,
                shard_plan=shard_plan,
                spans=spans,
                log_timing=bool(settings.profile),
            )
            logger.info(f"kernel launches: {json.dumps(stats['kernel_launches'])}")

    if device is not None and device.type == "cuda":
        import torch

        logger.info(
            f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB "
            f"allocated on {device}"
        )


def _fork_workers(settings: Settings, n: int, logger) -> list[int] | None:
    """Run the N shards of ``run_local_workers`` as forked children of this
    process; returns the ids of the workers that failed.

    The parent loads the imports and parses the reference FASTA once, and
    builds the CUDA kernels once for ``--device cuda``; the children inherit
    all of it.  It makes no CUDA call: a child forked after CUDA is
    initialised cannot use the device.  So where CUDA is already initialised
    here, it returns None and the caller starts subprocess workers."""
    import dataclasses
    import traceback

    t0 = time.perf_counter()
    import torch

    if torch.cuda.is_initialized():
        logger.info(
            "CUDA already initialized in this process; using subprocess workers"
        )
        return None

    import portello_tpu_torch.models.pipeline_model  # noqa: F401
    import portello_tpu_torch.pipeline.native_feed  # noqa: F401

    if settings.device == "cuda":
        from portello_tpu_torch.kernels import _cuda

        try:
            _cuda.ensure_built()
        except RuntimeError as e:
            logger.warning(
                f"CUDA kernel build before the fork failed ({e}); each "
                "worker builds its own"
            )

    ref_cl = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
    reference = get_chrom_array(settings.ref_filename, ref_cl, logger)

    logger.info(
        f"Forking {n} workers after {time.perf_counter() - t0:.2f} s of "
        "shared preload (imports, kernel build, FASTA)"
    )
    pids = []
    for w in range(n):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                # A torch CPU op run in this process before the fork leaves
                # OpenMP's pool without its threads in the child, where a
                # parallel region would wait on them forever; one thread
                # per worker never enters the pool, and the workers are the
                # parallelism.
                torch.set_num_threads(1)
                child = dataclasses.replace(
                    settings, local_workers=1, num_hosts=n, host_id=w
                )
                run(child, preloaded_reference=reference)
                code = 0
            except SystemExit as e:
                if isinstance(e.code, int):
                    code = e.code
                elif e.code:
                    print(e.code, file=sys.stderr)
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids.append(pid)
    failed = []
    for w, pid in enumerate(pids):
        _, status = os.waitpid(pid, 0)
        if os.waitstatus_to_exitcode(status) != 0:
            failed.append(w)
    return failed


def run_local_workers(settings: Settings, argv: list[str]) -> None:
    """Fan phase 2 out over ``--local-workers`` N processes on this machine
    and merge their output shards.

    Phase 1 runs once, here, into a contig index that every worker loads.
    Each worker is a ``--num-hosts N --host-id w`` run: forked from this
    process, or started as ``python -m portello_tpu_torch.main`` under
    ``PTPU_FORK_WORKERS=0`` or where forking is unsafe.  On one card every
    worker holds its own CUDA context and its own resident genome."""
    import dataclasses
    import subprocess
    import tempfile

    from portello_tpu_torch.io.aln_input import is_cram_file
    from portello_tpu_torch.tools.merge import merge_bams

    logger = setup_logger()
    n = settings.local_workers
    if settings.remapped_read_output == "-":
        raise SystemExit("--local-workers does not support stdout output")
    base_args = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--local-workers":
            skip = True
            continue
        if a.startswith("--local-workers="):
            continue
        base_args.append(a)

    temps: list[str] = []
    try:
        if settings.contig_index is None or not os.path.exists(
            settings.contig_index
        ):
            from portello_tpu_torch.pipeline.contig_scan import save_contig_index

            ref_cl = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
            asm_cl = ChromList.from_bam_filename(settings.read_to_assembly_bam)
            region = (
                None if settings.target_region is None
                else GenomeSegment.from_region_str(ref_cl, settings.target_region)
            )
            # phase 1 needs sequences only to decode a CRAM contig input
            ref_seqs = (
                get_chrom_array(settings.ref_filename, ref_cl, logger)
                if is_cram_file(settings.assembly_to_ref_bam)
                else None
            )
            info = scan_contig_bam(
                settings.assembly_to_ref_bam, ref_cl, asm_cl, region,
                max_join_gap=settings.max_join_gap, reference_seqs=ref_seqs,
                thread_count=settings.thread_count,
            )
            if settings.contig_index is not None:
                # the user asked for the cache at this path: write it here,
                # so the workers all load it and none races to write it
                index_path = settings.contig_index
            else:
                fd, index_path = tempfile.mkstemp(
                    suffix=".ptidx", prefix="ptpu_cidx_"
                )
                os.close(fd)
                temps.append(index_path)
                base_args += ["--contig-index", index_path]
                settings = dataclasses.replace(settings, contig_index=index_path)
            save_contig_index(
                index_path, info, ref_cl, asm_cl, region, settings.max_join_gap
            )
            logger.info("Scanned contig alignments once; index cached for workers")

        logger.info(f"Running phase 2 across {n} local worker processes")
        t0 = time.perf_counter()
        use_fork = hasattr(os, "fork") and (
            os.environ.get("PTPU_FORK_WORKERS", "1") != "0"
        )
        failed = _fork_workers(settings, n, logger) if use_fork else None
        if failed is None:
            logger.info(f"Starting {n} subprocess workers")
            procs = [
                subprocess.Popen([
                    sys.executable, "-m", "portello_tpu_torch.main", *base_args,
                    "--num-hosts", str(n), "--host-id", str(w),
                ])
                for w in range(n)
            ]
            failed = [w for w, p in enumerate(procs) if p.wait() != 0]
        if failed:
            raise SystemExit(f"worker processes failed: {failed}")
        t1 = time.perf_counter()

        for output in (
            settings.remapped_read_output, settings.unassembled_read_output
        ):
            shards = [shard_output_path(output, w, n) for w in range(n)]
            merge_bams(
                output, shards, n_threads=max(1, settings.thread_count // 2)
            )
            for s in shards:
                os.remove(s)
        logger.info(
            f"Merged {n} worker shards in {time.perf_counter() - t1:.2f} s "
            f"(the workers took {t1 - t0:.2f} s)"
        )
    finally:
        for t in temps:
            if os.path.exists(t):
                os.remove(t)


def main(argv=None) -> None:
    settings = parse_settings(argv)
    settings = validate_and_fix_settings(settings)
    setup_logger()
    try:
        validate_settings_data(settings)
        if settings.local_workers > 1:
            run_local_workers(
                settings, list(argv if argv is not None else sys.argv[1:])
            )
        else:
            run(settings)
    except Exception as err:
        print(err, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
