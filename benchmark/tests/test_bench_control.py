"""The control of each cell, at a small size on the CPU: the plain
reference put in the program's place, computed with float8 operands (the
precision below the configurations' bfloat16), comes out not correct under
the cell's limits. The same readings on the card at the cells' sizes are
`python3 -m benchmark.control`'s (PERF.md gives them)."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark import control
from benchmark.tests.conftest import SEED, small_cell

CELLS = ["sp-gan-256.train-b128", "vgg16-places365.finetune-b256"]


def _fails(numbers: dict, limits: dict) -> list:
    return [name for name, limit in limits.items() if numbers[name] > limit]


@pytest.mark.parametrize("cell_name", CELLS)
def test_float8_control_is_not_correct(cell_name):
    cell = small_cell(cell_name, "bfloat16")
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    session = entry.Session(cell, SEED, torch.device("cpu"), False)
    session.window(0.5)
    session.check()
    readings, _ = control.training_controls(entry, session, cell)
    assert _fails(readings["fp8"], cell.limits), readings["fp8"]
    # the faults a training cell can have, planted in the reference
    assert _fails(readings["half_batch"], cell.limits), readings["half_batch"]
    assert _fails(readings["no_update"], cell.limits)
