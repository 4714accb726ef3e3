"""Shared fixtures of the benchmark's own tests: the cells at a small size
on the CPU (the program's kernels run their plain versions there).

    python -m pytest benchmark/tests -q -p no:cacheprovider

Run from the root of the repository; the tests marked `cuda` run a cell at
full size and skip without a card. What a test knows of a cell comes from
BENCHMARK.json and from the cell's entry module (`benchmark/entries/`,
named by its traffic mix), which declares its own test size.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 977  # beyond 32 signed bits, as the driver's seeds are


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells(root: Path = ROOT) -> list:
    """The names of the cells of `root`/BENCHMARK.json, in its order."""
    return [w["name"] for w in bench(root)["workloads"]]


def entry_of(name: str, root: Path = ROOT):
    """The entry module that runs the cell `name`, found as the harness
    finds it: by its traffic mix's `entry`."""
    cell = harness.load_cell(root, name)
    return importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")


def small_cell(name: str, dtype: str = "float32",
               root: Path = ROOT) -> harness.Cell:
    """The cell `name` at the tests' size: its entry's TEST_CONFIG and
    TEST_TRAFFIC over the cell's configuration and traffic mix."""
    cell, entry = harness.load_cell(root, name), entry_of(name, root)
    return dataclasses.replace(
        cell, config=dict(cell.config, **entry.TEST_CONFIG,
                          compute_dtype=dtype),
        traffic=dict(cell.traffic, **entry.TEST_TRAFFIC))


def run_small(name: str, trace: bool = False, tamper=None,
              dtype: str = "float32", seconds: float = 0.5,
              seed: int = SEED, root: Path = ROOT) -> dict:
    return harness.run_cell(small_cell(name, dtype, root), seed, seconds,
                            trace, torch.device("cpu"), time.perf_counter(),
                            tamper=tamper)


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
