"""The port stands alone: no module of ``portello_tpu_torch`` and nothing in
``chip_smoke.py`` or ``scripts/torch_*.py`` imports the JAX package ``portello_tpu`` (or jax), at any
level of the syntax tree; the port's copies of the JAX package's host
modules and C++ sources equal their originals but for the import paths, or,
for the sources the port has changed since, but for a recorded diff;
the copied numpy oracle computes what the original does; and a contig index
written by ``portello_tpu.main`` loads into the port's classes without
importing ``portello_tpu``."""

import ast
import difflib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from portello_tpu.ops import blockmap as jax_blockmap
from portello_tpu.ops import liftover as jax_liftover
from portello_tpu.ops import shift as jax_shift
from portello_tpu.ops import simplify as jax_simplify
from portello_tpu.testutil.simulate import apply_edits, make_scenario, rand_seq
from portello_tpu_torch.ops import blockmap as port_blockmap
from portello_tpu_torch.ops import liftover as port_liftover
from portello_tpu_torch.ops import shift as port_shift
from portello_tpu_torch.ops import simplify as port_simplify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "portello_tpu_torch")
REFUSED = ("portello_tpu", "jax")


def _port_sources():
    scripts = os.path.join(REPO, "scripts")
    out = ["chip_smoke.py"] + sorted(
        os.path.join("scripts", f) for f in os.listdir(scripts)
        if f.startswith("torch_") and f.endswith(".py"))
    for root, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d not in ("_build", "__pycache__"))
        out += sorted(os.path.relpath(os.path.join(root, f), REPO)
                      for f in files if f.endswith(".py"))
    return out


def _refused(module: str) -> bool:
    return any(module == r or module.startswith(r + ".") for r in REFUSED)


@pytest.mark.parametrize("rel", _port_sources())
def test_no_import_of_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _refused(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _refused(node.module or ""):
                found.append(node.module)
    assert not found, f"{rel} imports {found}"


# The host modules and C++ sources copied from the JAX package, at the same
# relative paths.
COPIED = (
    "_version.py", "cli.py", "logger.py",
    "io/__init__.py", "io/aln_input.py", "io/bai.py", "io/bam.py",
    "io/bgzf.py", "io/fasta.py", "io/index_build.py", "io/native_codec.py",
    "io/crai.py", "io/cram.py", "io/rans_nx16.py", "io/tok3.py",
    "io/fqzcomp.py", "io/arith_nx16.py",
    "ops/__init__.py", "ops/blockmap.py", "ops/cigar.py", "ops/clip.py",
    "ops/homology.py", "ops/liftover.py", "ops/score.py", "ops/seq.py",
    "ops/shift.py", "ops/simplify.py", "ops/native_core.py",
    "utils/__init__.py", "utils/chrom_list.py", "utils/genome_segment.py",
    "utils/int_range.py", "utils/progress.py", "utils/regions.py",
    "utils/misc.py", "utils/containers.py", "utils/prob.py",
    "auxlib/__init__.py", "auxlib/basemod.py", "auxlib/bigwig.py",
    "tools/merge.py", "tools/view.py", "tools/index.py", "tools/sort.py",
    "pipeline/contig_scan.py", "pipeline/read_scan.py",
    "pipeline/split_read.py",
    "testutil/simulate.py",
    "io/native/ptscan.cc", "io/native/ptio.cc", "io/native/ptcore.cc",
)

# The only lines that differ beyond the import paths: the codec and core
# libraries build into the port's _build/, and the contig index loads
# through a reader that maps the JAX package's class paths to the port's.
_UNPICKLER = textwrap.dedent('''\
    def _index_unpickler(f):
        """A pickle reader that loads an index written by either CLI into this
        package's classes: the payload names its classes by module path, and
        ``portello_tpu.*`` paths (an index from ``portello_tpu.main``) map to
        ``portello_tpu_torch.*``, so loading never imports the JAX package."""
        import pickle

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module == "portello_tpu" or module.startswith("portello_tpu."):
                    module = "portello_tpu_torch" + module[len("portello_tpu"):]
                return super().find_class(module, name)

        return _Unpickler(f)


    ''')
EXPECTED_EDITS = {
    "io/native_codec.py": (
        ('_SO = os.path.join(_HERE, "..", "_build", "native", "ptio.so")',
         '_SO = os.path.join(_HERE, "native", "_build", "ptio.so")'),
    ),
    "ops/native_core.py": (
        ('_SO = os.path.join(_HERE, "..", "_build", "native", "ptcore.so")',
         '_SO = os.path.join(_HERE, "..", "io", "native", "_build", '
         '"ptcore.so")'),
    ),
    "pipeline/contig_scan.py": (
        (_UNPICKLER, ""),
        ('    with open(path, "rb") as f:\n'
         '        payload = _index_unpickler(f).load()',
         '    import pickle\n\n    with open(path, "rb") as f:\n'
         '        payload = pickle.load(f)'),
    ),
}


# Copies that the port has changed on purpose since: the native feed's
# sources, which carry the port's waits, CPU seconds and spans, and the
# FASTA parser, which drops line ends and uppercases in one pass.  Each
# differs from its original by the unified diff kept in EDITS_DIR; after a
# deliberate change, ``PYTHONPATH=. python tests/test_torch_self_contained.py``
# writes the diffs anew.
DIFFED = ("io/native/ptscan.cc", "io/native/ptio.cc", "io/fasta.py")
EDITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "port_edits")


def _diff(rel: str) -> str:
    with open(os.path.join(REPO, "portello_tpu", rel)) as f:
        original = f.read().splitlines(keepends=True)
    with open(os.path.join(PORT, rel)) as f:
        copy = f.read().splitlines(keepends=True)
    return "".join(difflib.unified_diff(original, copy, f"portello_tpu/{rel}",
                                        f"portello_tpu_torch/{rel}"))


def _diff_path(rel: str) -> str:
    return os.path.join(EDITS_DIR, os.path.basename(rel) + ".diff")


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_original_but_for_import_paths(rel):
    if rel in DIFFED:
        with open(_diff_path(rel)) as f:
            assert _diff(rel) == f.read(), f"{rel} drifted from its diff"
        return
    with open(os.path.join(REPO, "portello_tpu", rel)) as f:
        original = f.read()
    with open(os.path.join(PORT, rel)) as f:
        copy = f.read()
    if rel.endswith(".py"):
        original = original.replace("portello_tpu.", "portello_tpu_torch.")
    for port_text, jax_text in EXPECTED_EDITS.get(rel, ()):
        assert copy.count(port_text) == 1, port_text
        copy = copy.replace(port_text, jax_text)
    assert copy == original


def _oracle_case(seed: int):
    """A contig edited from a random reference (=/X ops) and a read edited
    from a stretch of the contig (M ops), with indels in both."""
    rng = np.random.default_rng(seed)
    ref = rand_seq(rng, 3000)
    contig, contig_cigar = apply_edits(ref, rng, 0.01, 0.01)
    ref_pos = int(rng.integers(0, 1000))
    read_pos = int(rng.integers(0, len(contig) // 4))
    read, read_cigar = apply_edits(contig[read_pos:read_pos + 1500], rng,
                                   0.02, 0.03, eqx=False)
    return contig, contig_cigar, ref_pos, read, read_cigar, read_pos


def _oracle(fn: str, mods, case):
    blockmap, liftover, simplify, shift = mods
    contig, contig_cigar, ref_pos, read, read_cigar, read_pos = case
    bm = blockmap.build_block_map(ref_pos, contig_cigar, False)
    if fn == "build_block_map":
        return bm.keys, bm.vals
    if fn == "liftover_read_alignment":
        return liftover.liftover_read_alignment(bm, read_pos, read_cigar)
    if fn == "simplify_alignment_indels":
        return simplify.simplify_alignment_indels(read_pos, read_cigar,
                                                  contig, read)
    return shift.left_shift_indels(read_pos, read_cigar, contig, read)


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("fn", ["build_block_map", "liftover_read_alignment",
                                "simplify_alignment_indels",
                                "left_shift_indels"])
def test_oracle_copies_equal_jax(fn, seed):
    case = _oracle_case(seed)
    got = _oracle(fn, (port_blockmap, port_liftover, port_simplify,
                       port_shift), case)
    want = _oracle(fn, (jax_blockmap, jax_liftover, jax_simplify,
                        jax_shift), case)
    assert got is not None and want is not None
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(g, w), fn


INDEX_PROGRAM = textwrap.dedent(
    """
    import sys


    class NoJaxPackage:
        def find_spec(self, name, path=None, target=None):
            if name in ("jax", "portello_tpu") or name.startswith(
                    ("jax.", "portello_tpu.")):
                raise ImportError(f"{name} imported on the port's path")
            return None


    sys.meta_path.insert(0, NoJaxPackage())
    from portello_tpu_torch.main import main

    main(sys.argv[1:])
    leaked = sorted(m for m in sys.modules if m in ("jax", "portello_tpu")
                    or m.startswith(("jax.", "portello_tpu.")))
    print("LEAKED", leaked)
    """
)


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def test_jax_contig_index_loads_in_port(tmp_path):
    """An index written by ``portello_tpu.main --contig-index`` loads into
    the port's classes in a fresh interpreter that refuses the JAX package,
    and the port's output from it equals the JAX package's."""
    from portello_tpu.main import main as jax_main

    make_scenario(str(tmp_path), rng=np.random.default_rng(23),
                  n_reads_per_contig=20, read_len=300)
    index = tmp_path / "contigs.ptidx"

    def args(tag, device):
        return [
            "--assembly-to-ref", str(tmp_path / "asm_to_ref.bam"),
            "--read-to-assembly", str(tmp_path / "read_to_asm.bam"),
            "--remapped-read-output", str(tmp_path / f"remapped_{tag}.bam"),
            "--unassembled-read-output", str(tmp_path / f"un_{tag}.bam"),
            "--ref", str(tmp_path / "ref.fa"), "--device", device,
            "--batch-size", "16", "--contig-index", str(index),
        ]

    jax_main(args("jax", "host"))
    assert index.exists()
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for tag, device in (("port_cpu", "cpu"), ("port_host", "host")):
        p = subprocess.run(
            [sys.executable, "-c", INDEX_PROGRAM, *args(tag, device)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert p.returncode == 0, p.stderr[-3000:]
        assert "Loaded contig mapping index" in p.stderr
        assert "LEAKED []" in p.stdout
        for kind in ("remapped", "un"):
            assert _records(tmp_path / f"{kind}_{tag}.bam") == _records(
                tmp_path / f"{kind}_jax.bam"), (tag, kind)
    assert len(_records(tmp_path / "remapped_jax.bam")) > 0


if __name__ == "__main__":
    os.makedirs(EDITS_DIR, exist_ok=True)
    for rel in DIFFED:
        with open(_diff_path(rel), "w") as f:
            f.write(_diff(rel))
