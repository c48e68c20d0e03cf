"""Host-side (numpy) alignment algebra.

This package is the exact-semantics layer: every function here reproduces the
behavior of the corresponding reference routine (cited per-function) and serves as
the conformance oracle for the JAX device kernels in ``portello_tpu_torch.kernels``.

CIGAR representation: an ``int64`` numpy array of shape ``(n, 2)`` where column 0 is
the BAM op code (M=0 I=1 D=2 N=3 S=4 H=5 P=6 '='=7 X=8) and column 1 is the op
length.  This dense two-column tensor layout is chosen (instead of an enum list)
because it is the same layout the device kernels consume after padding.
"""

from portello_tpu_torch.ops import cigar  # noqa: F401
