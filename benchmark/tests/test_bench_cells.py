"""CPU rehearsals of every cell at a small size: the result line's keys and
the metrics' names and units as BENCHMARK.json declares them; the plain
reference held against the program at float32 (both sides compute the same
arithmetic, so the gaps are round-off); the planted faults come out not
correct."""

from __future__ import annotations

import contextlib
import json
import time
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, SEED, run_small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# round-off between two float32 computations of the same arithmetic in
# another order: Adam's first steps move a near-zero gradient's leaf by
# about lr whatever its sign, so the change of the parameters is looser
FLOAT32_GAPS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "grad_p90_gap": 1e-3,
                "change_gap": 1e-2, "first_output_err": 1e-4}


def declared(cell: str, trace: bool) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    return {m["name"]: m["unit"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_holds_to_the_reference(cell, trace):
    result = run_small(cell, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    units = declared(cell, trace)
    for name, metric in result["metrics"].items():
        assert units[name] == metric["unit"]
    if not trace:  # every end-to-end metric is there; readers may be silent
        assert set(result["metrics"]) == set(units)
    else:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, check in result["checks"].items():
        assert check["value"] <= FLOAT32_GAPS[name], (name, check)
    json.loads(json.dumps(result))


def _state_unchanged(session):
    """The step's updates dropped: every optimizer step a no-op."""
    for opt in _optimizers(session):
        opt.step = lambda *args, **kwargs: None


def _optimizers(session):
    if hasattr(session, "trainer"):
        return [session.trainer.state.g_optimizer,
                session.trainer.state.d_optimizer]
    return [session.optimizer]


def _first_rows(x):
    """The first half of the rows of a tensor, or of each in a sequence."""
    if isinstance(x, (list, tuple)):
        return type(x)(_first_rows(t) for t in x)
    return x[:x.shape[0] // 2] if isinstance(x, torch.Tensor) else x


def _on_first_rows(loss):
    return lambda *args: loss(*(_first_rows(a) for a in args))


def _half_batch(session):
    """Half of the batch left out: the forwards run on every row, and each
    loss is the mean over the first half's rows alone."""
    if hasattr(session, "trainer"):
        from semantic_pyramid_for_image_generation_torch.train import step

        names = ("lsgan_discriminator_loss", "lsgan_generator_loss",
                 "diversity_loss", "semantic_reconstruction_loss")
        patches = [mock.patch.object(step, name,
                                     _on_first_rows(getattr(step, name)))
                   for name in names]
        owner, attr = session.trainer, "step_fn"
    else:
        patches = [mock.patch.object(
            torch.nn.functional, "cross_entropy",
            _on_first_rows(torch.nn.functional.cross_entropy))]
        owner, attr = session, "train_step"
    inner = getattr(owner, attr)

    def half(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            return inner(*args, **kwargs)

    setattr(owner, attr, half)


FAULTS = [(cell, f) for cell in CELLS
          for f in (_state_unchanged, _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_planted_fault_is_not_correct(cell, fault):
    result = run_small(cell, tamper=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    """A short run of the cell at full size on the card is correct."""
    result = harness.run_cell(harness.load_cell(ROOT, cell), SEED + 1, 3.0,
                              False, card, time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert torch.cuda.get_device_name(card) == result["device"]["kind"]
