#!/usr/bin/env bash
# Static gate of the PyTorch port (portello_tpu_torch), beside
# scripts/check.sh, which gates the JAX package:
#   1. scripts/lint_lite.py  -- AST lint of the port's modules, its tests
#      (tests/test_torch_*.py), its scripts (scripts/torch_*.py) and
#      chip_smoke.py
#   2. python -m compileall  -- bytecode-compiles the same files
#   3. g++ -fsyntax-only -Wall -Wextra -Werror over the port's
#      io/native/*.cc
# The CUDA sources (csrc/*.cu) need nvcc; chip_smoke.py builds them on the
# card.
#
#     bash scripts/torch_check.sh     # prints [torch_check] OK
set -u
cd "$(dirname "$0")/.."

fail=0
files=$(find portello_tpu_torch -name "*.py" -not -path "*/_build/*";
        ls tests/test_torch_*.py scripts/torch_*.py chip_smoke.py)

echo "[torch_check] lint_lite over portello_tpu_torch/ tests/test_torch_*.py scripts/torch_*.py chip_smoke.py ..."
# shellcheck disable=SC2086
python scripts/lint_lite.py $files || fail=1

echo "[torch_check] compileall ..."
# shellcheck disable=SC2086
python -m compileall -q $files || fail=1

echo "[torch_check] g++ -Wall -Wextra -Werror -fsyntax-only portello_tpu_torch/io/native/*.cc ..."
for f in portello_tpu_torch/io/native/*.cc; do
    g++ -std=c++17 -fsyntax-only -Wall -Wextra -Werror "$f" || fail=1
done

if [ "$fail" -ne 0 ]; then
    echo "[torch_check] FAILED"
    exit 1
fi
echo "[torch_check] OK"
