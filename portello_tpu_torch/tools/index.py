"""Build a .bai/.csi index for a coordinate-sorted BAM, or a .crai for a
CRAM (samtools index equivalent; --csi covers contigs past the BAI 2^29
limit; CRAM inputs are detected by magic and get a .crai)."""

from __future__ import annotations

import argparse

from portello_tpu_torch.io.index_build import build_bai, build_csi


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="portello-tpu index")
    p.add_argument("bam", help="BAM or CRAM file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument(
        "--csi", action="store_true",
        help="build a CSI index (required for contigs > 2^29-1 bp)",
    )
    p.add_argument(
        "--min-shift", type=int, default=14,
        help="CSI minimal interval width as a power of two (default 14)",
    )
    p.add_argument(
        "--ref", default=None,
        help="reference FASTA (CRAM inputs whose multi-reference slices "
             "need the external reference to decode record positions)",
    )
    args = p.parse_args(argv)
    from portello_tpu_torch.io.aln_input import is_cram_file

    if is_cram_file(args.bam):
        from portello_tpu_torch.io.index_build import build_crai

        reference = None
        if args.ref:
            from portello_tpu_torch.io.fasta import get_genome_ref_from_fasta

            reference = get_genome_ref_from_fasta(args.ref).chroms
        print(build_crai(args.bam, args.output, reference=reference))
        return
    if args.csi:
        out = build_csi(args.bam, args.output, min_shift=args.min_shift)
    else:
        out = build_bai(args.bam, args.output)
    print(out)


if __name__ == "__main__":
    main()
