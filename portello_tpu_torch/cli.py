"""Command-line interface (reference src/cli.rs:8-174 parity).

Flags mirror the reference: --assembly-to-ref, --read-to-assembly,
--remapped-read-output ('-' = uncompressed stdout BAM),
--unassembled-read-output, --ref, --target-region, --threads; plus TPU-native
extensions (--device, --batch-size) the reference has no equivalent for.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass

from portello_tpu_torch._version import PROGRAM_NAME, PROGRAM_VERSION

EX_USAGE = 64
EX_DATAERR = 65


@dataclass
class Settings:
    assembly_to_ref_bam: str
    read_to_assembly_bam: str
    remapped_read_output: str
    unassembled_read_output: str
    ref_filename: str
    target_region: str | None
    thread_count: int
    device: str = "auto"
    feed: str = "auto"
    batch_size: int = 512
    max_join_gap: int = 1000
    profile: str | None = None
    num_hosts: int = 1
    host_id: int = 0
    coordinator: str | None = None
    local_workers: int = 0
    contig_index: str | None = None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROGRAM_NAME,
        description=(
            "TPU-native liftover of HiFi read alignments from de novo assembly "
            "contigs onto a reference genome"
        ),
    )
    p.add_argument("--version", action="version", version=f"{PROGRAM_NAME} {PROGRAM_VERSION}")
    p.add_argument(
        "--assembly-to-ref", dest="assembly_to_ref_bam", metavar="FILE", required=True,
        help="Assembly contig to reference genome alignment file in BAM format "
        "(sorted and indexed)",
    )
    p.add_argument(
        "--read-to-assembly", dest="read_to_assembly_bam", metavar="FILE", required=True,
        help="Read to assembly alignment file in BAM format (sorted and indexed)",
    )
    p.add_argument(
        "--remapped-read-output", metavar="FILE", required=True,
        help="Filename for remapped read output, or '-' for uncompressed BAM on stdout",
    )
    p.add_argument(
        "--unassembled-read-output", metavar="FILE", required=True,
        help="Filename for reads not (well) mapped to any assembly contig",
    )
    p.add_argument(
        "--ref", dest="ref_filename", metavar="FILE", required=True,
        help="Genome reference in FASTA format",
    )
    p.add_argument(
        "--target-region", default=None,
        help="Restrict conversion to one region (debug option)",
    )
    p.add_argument(
        "--threads", dest="thread_count", metavar="THREAD_COUNT", type=int, default=0,
        help="Number of host threads (default: all logical cpus)",
    )
    p.add_argument(
        "--device", choices=["auto", "tpu", "cpu", "host"], default="auto",
        help="Compute path: TPU/CPU device kernels, or pure-host engine",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="Write a JAX device profiler trace for phase 2 to DIR and log "
        "per-stage feed timing",
    )
    p.add_argument(
        "--max-join-gap", type=int, default=1000, metavar="BASES",
        help="Max reference gap for joining colinear contig split segments "
        "(reference hard-codes 1000)",
    )
    p.add_argument(
        "--feed", choices=["auto", "native", "python"], default="auto",
        help="Phase-2 host feed: native C++ scanner or Python (auto = native "
        "when available and a device engine is in use)",
    )
    p.add_argument(
        "--batch-size", type=int, default=512,
        help="Reads per device batch",
    )
    p.add_argument(
        "--num-hosts", type=int, default=1,
        help="Total hosts in a multi-host run; each host lifts its owned "
        "contig subset and writes an output shard (merge with "
        "'python -m portello_tpu_torch.tools.merge')",
    )
    p.add_argument(
        "--host-id", type=int, default=0,
        help="This host's index in [0, num-hosts)",
    )
    p.add_argument(
        "--coordinator", default=None,
        help="JAX distributed coordinator address (host:port) for multi-host "
        "device meshes; omit for independent per-host runs",
    )
    p.add_argument(
        "--local-workers", type=int, default=0,
        help="Run phase 2 as N worker processes on this machine (contig-"
        "sharded, like the reference's thread pool but across GILs) and merge "
        "their output shards automatically",
    )
    p.add_argument(
        "--contig-index", default=None, metavar="PATH",
        help="Phase-1 contig mapping index cache: loaded when PATH exists "
        "(skipping the contig scan), written after the scan otherwise.  "
        "Lets multi-host/multi-worker runs scan the contig BAM once "
        "(--local-workers does this automatically)",
    )
    return p


def parse_settings(argv=None) -> Settings:
    args = build_parser().parse_args(argv)
    return Settings(**vars(args))


def validate_and_fix_settings(settings: Settings) -> Settings:
    """Cheap filesystem checks (cli.rs:86-141)."""

    def die(msg: str):
        print(f"Invalid command-line setting: {msg}", file=sys.stderr)
        sys.exit(EX_USAGE)

    for path, label in (
        (settings.assembly_to_ref_bam, "contig-to-ref bam"),
        (settings.read_to_assembly_bam, "read-to-contig bam"),
        (settings.ref_filename, "reference fasta"),
    ):
        if not path:
            die(f"Must specify {label} file")
        if not os.path.exists(path):
            die(f"Can't find specified {label} file: '{path}'")

    for path, label in (
        (settings.remapped_read_output, "remapped read output"),
        (settings.unassembled_read_output, "unassembled read output"),
    ):
        if path == "-" and label.startswith("remapped"):
            continue
        if not path:
            die(f"Must specify {label} file")
        parent = os.path.dirname(path)
        if parent and not os.path.exists(parent):
            die(f"Can't find existing directory for {label} file: '{path}'")

    if settings.thread_count < 0:
        die("--threads argument must be greater than 0")
    if settings.thread_count == 0:
        settings.thread_count = os.cpu_count() or 1
    return settings


def validate_settings_data(settings: Settings) -> None:
    """Data-dependent checks: indexed, non-truncated, mapped inputs
    (cli.rs:143-170)."""
    from portello_tpu_torch.io.aln_input import is_cram_file, open_alignment_input
    from portello_tpu_torch.io.bam import BamReader, assert_bam_eof

    for path in (settings.assembly_to_ref_bam, settings.read_to_assembly_bam):
        if is_cram_file(path):
            from portello_tpu_torch.io.cram import check_cram_eof

            if not check_cram_eof(path):
                raise SystemExit(
                    f"Input alignment file is truncated (no CRAM EOF "
                    f"container): '{path}'"
                )
            with open_alignment_input(path) as reader:
                try:
                    # reference semantics: every alignment input must be
                    # indexed (bam::IndexedReader::from_path — a .crai for
                    # CRAM; cli.rs:147-163)
                    reader.load_index()
                except FileNotFoundError as e:
                    raise SystemExit(
                        f"Failed to open input alignment file: {e}"
                    ) from None
                if not reader.header.refs:
                    raise SystemExit(
                        f"Input alignment file is not mapped: '{path}'"
                    )
            continue
        assert_bam_eof(path)
        with BamReader(path) as reader:
            try:
                reader.load_index()
            except FileNotFoundError as e:
                raise SystemExit(
                    f"Failed to open input alignment file: {e}"
                ) from None
            if not reader.header.refs:
                raise SystemExit(f"Input alignment file is not mapped: '{path}'")
