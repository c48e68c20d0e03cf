"""The harness on the card at a tiny size: each cell's set-up, window and
comparison through the CUDA kernels, traced and not."""

import pytest

from benchmark import run
from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", tiny.cells() + tiny.later())
def test_cell_on_card(tmp_path, cuda_device, cell, trace):
    r = run.run_cell(cell, 2**31 + 21, 0.1, trace, device=cuda_device,
                     bench_spec=tiny.spec(cell, 400),
                     cache=str(tmp_path / "inputs"), work=str(tmp_path / "work"))
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0
        assert "step.device_ms_per_batch" in r["metrics"]
