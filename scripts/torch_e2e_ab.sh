#!/bin/bash
# Compare the bench's e2e leg of two trees of this repository on one card,
# in turns: other, this, this, other (two rounds of each by default).
#
#     bash scripts/torch_e2e_ab.sh OTHER_TREE [ROUNDS] [OUT_DIR]
#
# OTHER_TREE is another checkout (say, the parent commit unpacked with
# `git archive` into a directory that .gitignore lists).  Each turn runs
# `portello_tpu_torch.bench.measure_e2e_fields("cuda")` in a fresh process
# of that tree (a warm-up CLI run, then the median of 3 at 10,000 reads,
# under PTPU_FEED_TIMING=1); the scenario cached in this tree's
# .bench_cache/ is shared with the other.  Writes each turn's JSON and log
# to OUT_DIR/ab_<n>_<tree>.{out,err} (a new temporary directory by
# default) and prints one line a turn.
set -u
OTHER=$(cd "$1" && pwd)
ROUNDS=${2:-1}
ROOT=$(pwd)
OUT=${3:-$(mktemp -d)}
mkdir -p "$OUT" "$OTHER/.bench_cache"
OUT=$(cd "$OUT" && pwd)
echo "writing to $OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for d in "$ROOT"/.bench_cache/torch_e2e_*; do
  [ -d "$d" ] && ln -sfn "$d" "$OTHER/.bench_cache/$(basename "$d")"
done
i=0
for _ in $(seq "$ROUNDS"); do
  for t in other this this other; do
    i=$((i + 1))
    if [ $t = other ]; then d=$OTHER; else d=$ROOT; fi
    (cd "$d" && PTPU_FEED_TIMING=1 python -c "import json, sys; sys.path.insert(0, '.'); from portello_tpu_torch.bench import measure_e2e_fields; print('E2E', json.dumps(measure_e2e_fields('cuda')))") \
      > "$OUT/ab_${i}_$t.out" 2> "$OUT/ab_${i}_$t.err"
    echo "$i $t rc=$? $(grep -h '^E2E' "$OUT/ab_${i}_$t.out")"
    grep -h "Compiled steps\|feed timing\|native phase split" "$OUT/ab_${i}_$t.err" | tail -3
  done
done
