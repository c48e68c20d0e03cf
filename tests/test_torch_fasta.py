"""The port's FASTA parser (one ``bytearray.translate`` pass a record) gives
the JAX package's arrays on the cases a reference file can hold: ragged and
CRLF lines, lowercase and IUPAC bases, blank lines, a header with a
description, an empty record and a last header with no newline; the arrays
are writable uint8, as the package's are."""

import numpy as np
import pytest

from portello_tpu.io import fasta as jfasta
from portello_tpu_torch.io import fasta as tfasta

CASES = {
    "plain": b">chr1\nACGT\nACGT\n>chr2\nTTGA\n",
    "ragged_crlf": b">chr1 description here\r\nACgtn\r\nRYkm\r\n\r\nac\r\n>chrM\r\nN\r\n",
    "no_final_newline": b">a\nacgtACGT\nAC",
    "empty_and_bare_last_header": b">a\n>b\nGGCC\n>c",
    "blank_lines_and_bytes": b"\n\n>x\n\nac\n\x01\xffz\n\n>y\n",
    "leading_text": b"junk before\n>z\nacgt\n",
}


@pytest.mark.parametrize("raw", CASES.values(), ids=CASES.keys())
def test_parse_equals_jax_package(tmp_path, raw):
    path = tmp_path / "ref.fa"
    path.write_bytes(raw)
    got = tfasta.get_genome_ref_from_fasta(str(path)).chroms
    want = jfasta.get_genome_ref_from_fasta(str(path)).chroms
    assert list(got) == list(want)
    for name, seq in want.items():
        assert got[name].dtype == np.uint8 and got[name].flags.writeable
        assert np.array_equal(got[name], seq), name


def test_parse_equals_jax_package_at_size(tmp_path):
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGTNacgtn", np.uint8)
    chroms = [(f"chr{i}", rng.choice(alpha, size=n).tobytes())
              for i, n in enumerate((100_003, 61, 60, 1, 250_000))]
    path = tmp_path / "ref.fa"
    tfasta.write_fasta(str(path), chroms, width=61)
    got = tfasta.get_genome_ref_from_fasta(str(path)).chroms
    want = jfasta.get_genome_ref_from_fasta(str(path)).chroms
    assert list(got) == [n for n, _ in chroms] == list(want)
    for name, seq in want.items():
        assert np.array_equal(got[name], seq), name
