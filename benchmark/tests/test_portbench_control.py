"""On the card, at each cell's own size: its control (the reference in the
program's place one precision lower) comes out not correct on three seeds, and the
program itself correct. Run on the chip:

    python3 -m pytest -q benchmark/tests/test_portbench_control.py
"""

import pytest

from benchmark import run
from benchmark.calibrate import readings

CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(cuda_device, workload):
    ctrl = readings(workload, [101, 202, 303], True, 4.0, cuda_device)
    assert not any(r["correct"] for r in ctrl), ctrl
    prog = readings(workload, [404], False, 4.0, cuda_device)
    assert all(r["correct"] for r in prog), prog
