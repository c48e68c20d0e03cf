"""BAM/CRAM -> SAM text dump (samtools view -h equivalent for inspection)."""

from __future__ import annotations

import argparse
import sys

from portello_tpu_torch.io.bam import BamReader


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="portello-tpu view")
    p.add_argument("bam")
    p.add_argument("--no-header", action="store_true")
    p.add_argument("--region", default=None, help="chrom:start-end (requires index)")
    args = p.parse_args(argv)
    from portello_tpu_torch.io.aln_input import open_alignment_input

    with open_alignment_input(args.bam) as reader:
        if not args.no_header:
            # the BAM text block may be NUL-padded and need not end in a
            # newline (spec-legal); normalize so the dump stays valid SAM
            text = reader.header.text.rstrip(b"\x00").decode()
            if text and not text.endswith("\n"):
                text += "\n"
            sys.stdout.write(text)
        if args.region:
            from portello_tpu_torch.utils.chrom_list import ChromList
            from portello_tpu_torch.utils.genome_segment import parse_samtools_region_string

            if not isinstance(reader, BamReader):
                raise SystemExit("--region requires an indexed BAM input")
            cl = ChromList.from_pairs(reader.header.refs)
            tid, beg, end = parse_samtools_region_string(cl, args.region)
            records = reader.fetch(tid, beg, end)
        else:
            records = iter(reader)
        for rec in records:
            sys.stdout.write(rec.to_sam(reader.header) + "\n")


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed early — normal CLI behavior
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
