"""The benchmark's control at a cell's own size: the reference without its
indel normalisation put in the program's place, on the cell's inputs for
each seed.  Its outputs are judged as a run's calls are (``run.compare``
and ``run.LIMITS``) and have to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Needs no GPU; the benchmark's own runs never run it."""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    _bench, _cell, config, mix = run.load_cell(a.workload)
    work = os.path.join(tempfile.gettempdir(), "portello_bench_control")
    for seed in a.seeds:
        try:
            r = run.control_readings(config, mix, seed,
                                     os.path.join(HERE, ".cache", "inputs"), work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": a.workload, "seed": seed, **r}), flush=True)
