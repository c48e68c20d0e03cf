"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name; the reference and the generator import nothing of the
port either."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
NEVER = {"jax", "jaxlib", "flax", "portello_tpu"}


def _modules():
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_walk_finds_every_part():
    rel = {os.path.relpath(p, BENCH) for p in _modules()}
    assert "run.py" in rel
    assert any(r.startswith("reference" + os.sep) for r in rel)
    assert any(r.startswith("metrics" + os.sep) for r in rel)


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    names = set(_top_level_imports(path))
    assert not names & NEVER, f"{path} imports {sorted(names & NEVER)}"
    rel = os.path.relpath(path, BENCH)
    if rel.startswith(("reference" + os.sep, "gen" + os.sep)):
        assert "portello_tpu_torch" not in names, f"{path} imports the port"


def test_top_level_name_compared_whole():
    assert "portello_tpu_torch".split(".")[0] not in NEVER
