"""Static bucket shapes for the forward step.

A jax-free copy of ``portello_tpu.models.batch.BucketConfig`` (that module
imports jax through ``kernels.cigar_kernels``); a test holds the two equal
field for field.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BucketConfig:
    """Static shapes for one bucket."""

    max_ops: int = 1024          # read->contig cigar ops
    max_blocks: int = 64         # contig->ref map entries in the read's window
    max_out: int = 0             # lifted cigar ops (0 -> derived)
    max_seq: int = 32768         # read length (bases)
    max_clusters: int = 512      # indel clusters for simplify
    window: int = 64             # base-compare window for simplify
    max_rows: int = 0            # liftover update-grid rows (0 -> proven bound)

    def resolved_max_out(self) -> int:
        # Each input op splits at most once per overlapped block boundary and
        # each block gap adds at most one Del.
        return self.max_out or (self.max_ops + 2 * self.max_blocks + 8)

    def resolved_max_rows(self) -> int:
        # Proven bound under the renumbered visit scheme: every rc op needs
        # inside_keys + 1 rows and window keys are disjoint across op
        # intervals, so total_rows <= n_ops + n_blocks.
        return self.max_rows or (self.max_ops + self.max_blocks)
