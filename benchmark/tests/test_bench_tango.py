"""The `tango-b8` cell (TANGO's full UNet through the Heun CFG teacher's
set-up, window and check) on the CPU at the tiny sizes, as
`test_bench_faults.py` runs the other cells: a sound run is correct and
each fault a generation cell can have is caught, at the port's tiny shapes
and at `common.tiny_unpadded()`, whose heads are 64 wide as TANGO's are, so
the UNet pads nothing. On the card, the control
fails the cell's limit (as `test_bench_control.py` holds the other cells)."""

import pytest
import torch

from benchmark import manifest
from benchmark.tests.common import tiny_pipeline, tiny_run, tiny_unpadded
from benchmark.tests.test_bench_control import SEEDS
from benchmark.tests.test_bench_faults import FAULTS

CELL = "tango-b8"
SIZES = {"tiny": tiny_pipeline, "tiny_unpadded": tiny_unpadded}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_sound_run_is_correct(size):
    r = tiny_run(CELL, pipeline=SIZES[size]())
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("size", sorted(SIZES))
def test_fault_is_not_correct(size, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = tiny_run(CELL, pipeline=SIZES[size]())
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_fails_the_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from benchmark.calibrate import readings

    cell = manifest.cell(CELL)
    limits = cell.spec["check"]["limit"]
    for seed in SEEDS:
        line = readings(cell, seed, control=True)
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["control"][k] > limits[k] for k in limits), line
