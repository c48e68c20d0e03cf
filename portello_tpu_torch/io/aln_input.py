"""Alignment-input dispatch: BAM or CRAM by magic bytes.

The reference accepts both formats via htslib (cli.rs:25,32); this helper
routes to the matching native reader.
"""

from __future__ import annotations


def is_cram_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"CRAM"


def open_alignment_input(path: str, reference=None):
    """Open a BAM or CRAM alignment file with the shared reader surface
    (.header, iteration, close, context manager)."""
    if is_cram_file(path):
        from portello_tpu_torch.io.cram import CramReader

        return CramReader(path, reference=reference)
    from portello_tpu_torch.io.bam import BamReader

    return BamReader(path)


def cram_to_bam(cram_path: str, bam_path: str, reference=None, n_threads: int = 1):
    """Transcode a CRAM file to BAM.

    The native phase-2 scanner (ptscan.cc) consumes the mmap'd BAM byte
    layout directly, so CRAM inputs are bridged through a one-pass transcode
    (htslib performs the same record normalization when reading CRAM: e.g.
    unmapped records decode with MAPQ 0).  Low compression level: the output
    is a scan-once temporary.
    """
    from portello_tpu_torch.io.bam import BamWriter
    from portello_tpu_torch.io.cram import CramReader

    with CramReader(cram_path, reference=reference) as r:
        w = BamWriter(bam_path, r.header, level=1, n_threads=n_threads)
        try:
            for rec in r:
                w.write(rec)
        finally:
            w.close()
