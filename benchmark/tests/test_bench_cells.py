"""CPU rehearsals of every cell at a small size: the result line's keys and
the metrics' names and units as BENCHMARK.json declares them; the plain
reference held against the program at float32 (both sides compute the same
arithmetic, so the gaps are round-off, within the tolerances the cell's
entry declares); the planted faults the entry declares come out not
correct; each entry declares what the tests and `control.py` read of it.
The checks take the root of a benchmark, so that `test_bench_extend.py`
holds a kind of work added as new files to the same ones."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import (
    ROOT,
    SEED,
    bench,
    cells,
    entry_of,
    run_small,
)

CELLS = cells()
# the faults every training cell can have (a cell that reports the
# training rate is one)
TRAINING_FAULTS = ("state_unchanged", "half_batch")
SESSION = ("window", "subwindow", "finish", "step_flops", "check")


def declared(cell: str, trace: bool, root=ROOT) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    return {m["name"]: m["unit"] for m in bench(root)[kind]
            if cell in m.get("workloads", [cell])}


def holds_to_the_reference(cell: str, trace: bool, root=ROOT) -> None:
    result = run_small(cell, trace=trace, root=root)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    units = declared(cell, trace, root)
    for name, metric in result["metrics"].items():
        assert units[name] == metric["unit"]
    if not trace:  # every end-to-end metric is there; readers may be silent
        assert set(result["metrics"]) == set(units)
    else:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    tolerances = entry_of(cell, root).FLOAT32_GAPS
    for name, check in result["checks"].items():
        assert name in tolerances, f"no float32 tolerance for {name}"
        assert check["value"] <= tolerances[name], (name, check)
    json.loads(json.dumps(result))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_holds_to_the_reference(cell, trace):
    holds_to_the_reference(cell, trace)


def entry_contract(cell: str, root=ROOT) -> None:
    """What the harness, the tests and `control.py` read of the cell's
    entry is there (README.md, "A new kind of work")."""
    loaded = harness.load_cell(root, cell)
    entry = entry_of(cell, root)
    for method in SESSION:
        assert callable(getattr(entry.Session, method)), method
    assert isinstance(entry.TEST_CONFIG, dict)
    assert isinstance(entry.TEST_TRAFFIC, dict)
    missing = set(loaded.limits) - set(entry.FLOAT32_GAPS)
    assert not missing, f"no float32 tolerance for {sorted(missing)}"
    assert entry.FAULTS and all(callable(f) for f in entry.FAULTS.values())
    if "train_images_per_s" in {m["name"] for m in loaded.end_to_end}:
        assert set(TRAINING_FAULTS) <= set(entry.FAULTS), sorted(entry.FAULTS)
    assert entry.CONTROLS
    assert callable(entry.control_readings) and callable(entry.gaps)
    assert isinstance(entry.OPENS_STEP_SPANS, bool)


@pytest.mark.parametrize("cell", CELLS)
def test_entry_declares_the_contract(cell):
    entry_contract(cell)


def fault_is_not_correct(cell: str, fault: str, root=ROOT) -> None:
    tamper = entry_of(cell, root).FAULTS[fault]
    result = run_small(cell, tamper=tamper, root=root)
    assert result["correct"] is False, result["checks"]


FAULTS = [(cell, fault) for cell in CELLS
          for fault in entry_of(cell).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_planted_fault_is_not_correct(cell, fault):
    fault_is_not_correct(cell, fault)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    """A short run of the cell at full size on the card is correct."""
    result = harness.run_cell(harness.load_cell(ROOT, cell), SEED + 1, 3.0,
                              False, card, time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert torch.cuda.get_device_name(card) == result["device"]["kind"]
