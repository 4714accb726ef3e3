"""Shared fixtures of the benchmark's own tests: the cells at a small size
on the CPU (the program's kernels run their plain versions there).

    python -m pytest benchmark/tests -q -p no:cacheprovider

Run from the root of the repository; the tests marked `cuda` run a cell at
full size and skip without a card.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 977  # beyond 32 signed bits, as the driver's seeds are
SMALL = {"channels_factor": 8.0, "vgg_width_factor": 8, "num_classes": 16}
SMALL_TRAIN = {"batch": 4, "pool": 3, "subwindow_units": [1, 1]}


def small_cell(name: str, dtype: str = "float32") -> harness.Cell:
    """The cell `name` at the tests' size: narrow widths and a few rows."""
    cell = harness.load_cell(ROOT, name)
    return dataclasses.replace(
        cell, config=dict(cell.config, **SMALL, compute_dtype=dtype),
        traffic=dict(cell.traffic, **SMALL_TRAIN))


def run_small(name: str, trace: bool = False, tamper=None,
              dtype: str = "float32", seconds: float = 0.5,
              seed: int = SEED) -> dict:
    return harness.run_cell(small_cell(name, dtype), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            tamper=tamper)


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
