"""Command-line entry point of the PyTorch port: ``python -m portello_tpu_torch.main``.

The same flags and exit codes as ``portello_tpu.main`` (whose parser and
validation it reuses), except ``--device``:

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
either feed: reverse-contig items run the reverse step ``rev_batch``.  Not
ported yet, and refused with a message: ``--profile``,
``--num-hosts``/``--coordinator`` and ``--local-workers``.
"""

from __future__ import annotations

import json
import os
import sys
import time

from portello_tpu._version import PROGRAM_NAME, PROGRAM_VERSION
from portello_tpu.cli import (
    Settings,
    build_parser as _jax_build_parser,
    validate_and_fix_settings,
    validate_settings_data,
)
from portello_tpu.logger import setup_logger
from portello_tpu.main import get_chrom_array
from portello_tpu.utils.chrom_list import ChromList
from portello_tpu.utils.genome_segment import GenomeSegment

DEVICES = ("cuda", "cpu", "host")


def build_parser():
    """portello_tpu's parser with the port's ``--device`` choices."""
    p = _jax_build_parser()
    for action in p._actions:
        if action.dest == "device":
            action.choices = list(DEVICES)
            action.default = "cuda"
            action.help = (
                "Compute path: cuda (GPU kernels), cpu (plain PyTorch) or "
                "host (exact host oracle)"
            )
    return p


def parse_settings(argv=None) -> Settings:
    return Settings(**vars(build_parser().parse_args(argv)))


def _unported(settings: Settings) -> str | None:
    if settings.device == "host":
        return None
    if settings.profile:
        return "--profile is not yet ported to portello_tpu_torch"
    if settings.num_hosts > 1 or settings.coordinator:
        return "multi-host runs are not yet ported to portello_tpu_torch"
    if settings.local_workers > 1:
        return "--local-workers is not yet ported to portello_tpu_torch"
    return None


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


def run(settings: Settings) -> None:
    logger = setup_logger()
    cmdline = " ".join(sys.argv)
    logger.info(f"Starting {PROGRAM_NAME} {PROGRAM_VERSION} (PyTorch port)")
    logger.info(f"cmdline: {cmdline}")
    logger.info(f"Running on {settings.thread_count} threads")
    start = time.monotonic()

    refused = _unported(settings)
    if refused:
        raise SystemExit(refused)
    device = select_device(settings)
    use_native_feed = False
    if device is not None:
        from portello_tpu.pipeline.native_feed import build_error, get_lib

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

    ref_chrom_list = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
    assembly_contig_list = ChromList.from_bam_filename(settings.read_to_assembly_bam)
    target_region = None
    if settings.target_region is not None:
        target_region = GenomeSegment.from_region_str(
            ref_chrom_list, settings.target_region
        )
    reference = get_chrom_array(settings.ref_filename, ref_chrom_list, logger)

    from portello_tpu.pipeline.contig_scan import (
        load_contig_index,
        save_contig_index,
        scan_contig_bam,
    )

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

    if device is None:
        from portello_tpu.pipeline.read_scan import scan_and_remap_reads

        scan_and_remap_reads(
            settings.read_to_assembly_bam,
            settings.remapped_read_output,
            settings.unassembled_read_output,
            reference,
            ref_chrom_list,
            all_contig_mapping_info,
            target_region is not None,
            cmdline=cmdline,
            engine=None,
            thread_count=settings.thread_count,
        )
    elif not use_native_feed:
        from portello_tpu.pipeline.read_scan import scan_and_remap_reads
        from portello_tpu_torch.models.pipeline_model import DeviceEngine

        engine = DeviceEngine(
            reference, assembly_contig_list, all_contig_mapping_info, device,
            batch_size=settings.batch_size,
        )
        scan_and_remap_reads(
            settings.read_to_assembly_bam,
            settings.remapped_read_output,
            settings.unassembled_read_output,
            reference,
            ref_chrom_list,
            all_contig_mapping_info,
            target_region is not None,
            cmdline=cmdline,
            engine=engine,
            thread_count=settings.thread_count,
        )
        stats = engine.stats
        logger.info(
            f"Python feed: {stats['batches']} device batches, rev_batches "
            f"{stats['rev_batches']} "
            f"({'host' if engine.host_shift else 'device'}-shift routing)"
        )
        logger.info(f"kernel launches: {json.dumps(stats['kernel_launches'])}")
    else:
        from portello_tpu.io.aln_input import is_cram_file
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
            settings.remapped_read_output,
            settings.unassembled_read_output,
            reference,
            ref_chrom_list,
            all_contig_mapping_info,
            target_region is not None,
            device,
            cmdline=cmdline,
            batch_size=settings.batch_size,
            thread_count=settings.thread_count,
            cram_reference=cram_reference,
        )
        logger.info(f"kernel launches: {json.dumps(stats['kernel_launches'])}")

    elapsed = time.monotonic() - start
    hh = int(elapsed // 3600)
    mm = int(elapsed % 3600 // 60)
    ss = elapsed % 60
    logger.info(
        f"{PROGRAM_NAME} completed. Total Runtime: {hh:02d}:{mm:02d}:{ss:06.3f}"
    )


def main(argv=None) -> None:
    settings = parse_settings(argv)
    settings = validate_and_fix_settings(settings)
    setup_logger()
    try:
        validate_settings_data(settings)
        run(settings)
    except Exception as err:
        print(err, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
