"""On the card: each cell at its own size, one seed and a short window,
comes out correct, and the control (the reference one precision below the
configuration's, in the program's place) does not. Skips without a card:

    python -m pytest -o addopts="" -m cuda perfbench/tests/test_perfbench_cuda.py
"""

from __future__ import annotations

import pytest
from tinycells import harness

from perfbench import control

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(card, workload):
    spec = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"), workload)
    limits = spec["config"]["limits"][spec["mix"]["driver"]]
    rows = {r["side"]: r for r in control.readings(workload, [2**31 + 3], [2**31 + 3], 8.0)}
    for side, passes in (("program", True), ("control", False)):
        numbers = rows[side]["numbers"]
        assert set(numbers) == set(limits), (side, numbers)
        over = [n for n, v in numbers.items() if not v <= limits[n]]
        assert (not over) == passes, (side, numbers)
