"""On the card, at each cell's own size: the control (the reference one
precision step below the configuration's, in the program's place) fails
the cell's limits on three seeds, and the program on the same seeds passes
them.  Card-only: run on the GPU machine with

    python3 -m pytest benchmark/tests -q -m cuda
"""

import pytest

from benchmark.harness import calibrate
from benchmark.harness.cell import load_cell
from benchmark.tests._tiny import workloads

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32, bf16 convolutions and the kernels exist only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_the_control_fails_and_the_program_passes(workload, card):
    cell = load_cell(workload)
    limits = cell.traffic["limits"]
    for seed in SEEDS:
        control = calibrate.control_readings(cell, seed, card)
        assert any(v > limits[k] for k, v in control.items()), (seed, control)
        program = calibrate.readings(cell, seed, card)
        assert all(v <= limits[k] for k, v in program.items()), (seed, program)
