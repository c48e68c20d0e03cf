"""Host I/O layer: BGZF/BAM codec, BAI/CSI index fetch, FASTA loading.

Replaces the reference's htslib dependency (reference Cargo.toml:20, the one
native C component of the reference stack).  Two implementations share one API:
a pure-Python codec (zlib-backed, used as reference implementation and fallback)
and a C++ codec in ``portello_tpu/io/native`` (threaded BGZF, bulk record
decode) selected automatically when built.
"""
