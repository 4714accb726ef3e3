"""The controls of each cell whose entry declares them, at a small size on
the CPU: the plain reference put in the program's place, computed with
float8 operands (the precision below the configurations' bfloat16), and the
faults a training cell can have, planted in the reference, come out not
correct under the cell's limits. The same readings on the card at the
cells' sizes are `python3 -m benchmark.control`'s (PERF.md gives them)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests.conftest import ROOT, SEED, cells, entry_of, small_cell

CELLS = [c for c in cells() if getattr(entry_of(c), "CONTROLS", ())]


def _fails(numbers: dict, limits: dict) -> list:
    return [name for name, limit in limits.items() if numbers[name] > limit]


def controls_are_not_correct(cell_name: str, root=ROOT) -> None:
    cell = small_cell(cell_name, "bfloat16", root)
    entry = entry_of(cell_name, root)
    session = entry.Session(cell, SEED, torch.device("cpu"), False)
    session.window(0.5)
    session.check()
    readings, _ = control.training_controls(entry, session)
    assert list(readings) == list(entry.CONTROLS)
    for name, numbers in readings.items():
        assert _fails(numbers, cell.limits), (name, numbers)


@pytest.mark.parametrize("cell_name", CELLS)
def test_float8_control_is_not_correct(cell_name):
    controls_are_not_correct(cell_name)
