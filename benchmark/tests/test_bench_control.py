"""The control: the reference without its indel normalisation, put in the
program's place and judged as a run's calls are, has to come out as not
correct (``run.control_readings``; ``benchmark/control.py`` runs it at a
cell's own size)."""

import pytest

from benchmark import run
from benchmark.tests import tiny


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 123456789])
@pytest.mark.parametrize("cell", tiny.cells() + tiny.later())
def test_control_fails(tmp_path, cell, seed):
    _bench, _cell, conf, mix = tiny.spec(cell, reads=300)
    r = run.control_readings(conf, mix, seed, str(tmp_path / "inputs"),
                             str(tmp_path / "work"))
    assert r["correct"] is False
    assert r["checks"]["reads_differing"]["value"] > r["checks"]["reads_differing"]["limit"]
    # the control lifts every read, so it is caught by the records, not the counts
    assert r["checks"]["records_count_off"]["value"] == 0
    assert r["reads_sampled"] >= 300
