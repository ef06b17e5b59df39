"""The control, on the card at each generation cell's own size: the plain
reference put in the program's place and computed through float8 (e4m3) at
every product, one precision below the configurations' bfloat16, must fail
a limit of the cell on three seeds. The readings that set the limits are
in PERF.md; `python3 -m benchmark.calibrate` prints them."""

import pytest
import torch

from benchmark import manifest

SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gen-b32", "teacher-b8", "gen-b1"])
def test_control_fails_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from benchmark.calibrate import readings

    cell = manifest.cell(name)
    limits = cell.spec["check"]["limit"]
    for seed in SEEDS:
        line = readings(cell, seed, control=True)
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["control"][k] > limits[k] for k in limits), line
