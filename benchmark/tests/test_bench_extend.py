"""A new kind of work joins the benchmark as new files only. A toy entry (a
two-layer net trained by Adam on an MSE loss, compared by check names no
other entry has), its configuration, traffic mix and limits, and a copy of
BENCHMARK.json that names its cell, all in a temporary directory, pass the
same contract, rehearsal, planted-fault and control checks as the real
cells; the toy's faults and controls come out not correct; and no file of
the benchmark changes on the way."""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
import shutil
import sys

import pytest

from benchmark.tests.conftest import ROOT, bench, cells, entry_of
from benchmark.tests.test_bench_cells import (
    entry_contract,
    fault_is_not_correct,
    holds_to_the_reference,
)
from benchmark.tests.test_bench_control import controls_are_not_correct
from benchmark.tests.test_bench_spans import span_metrics_declared
from benchmark.tests.test_bench_yardstick import contract_form

ENTRY = "toy_mlp"
CELL = "toy-mlp.toy-b64"
FAULTS = ("state_unchanged", "half_batch")
CONFIG = {"name": "toy-mlp", "source": "https://arxiv.org/abs/1412.6980",
          "file": "benchmark/configs/toy-mlp.json", "reduced": [],
          "why": "a two-layer tanh net trained by Adam on an MSE loss"}
WORKLOAD = {"name": CELL, "config": "toy-mlp", "traffic": "toy-b64",
            "chips": 1, "why": "Adam steps of batch 64 over a pool of 4"}
# what the toy's cell appends its name to: the training rate and the
# per-layer metrics it reports (not the span metrics: it opens no span)
REPORTS = ("train_images_per_s", "step_mfu_pct", "kernels_roofline",
           "device_idle_pct.train")
FILES = {
    "configs/toy-mlp.json": {"in_features": 16, "hidden": 32,
                             "out_features": 4, "lr": 0.01,
                             "compute_dtype": "float32", "reduced": []},
    "traffic/toy-b64.json": {"entry": ENTRY, "batch": 64, "pool": 4,
                             "checked_steps": 3, "subwindow_units": [4, 2]},
    "limits/toy-mlp.toy-b64.json": {"toy_loss_gap": 1e-3,
                                    "toy_change_gap": 1e-3},
}
TOY_ENTRY = '''"""A toy kind of work: a two-layer tanh net trained by
Adam on an MSE loss, held against a float64 reference with Adam written
out."""

import time

import torch

from benchmark import harness
from benchmark.entries import common

TEST_CONFIG = {}
TEST_TRAFFIC = {"batch": 8}
FLOAT32_GAPS = {"toy_loss_gap": 1e-4, "toy_change_gap": 1e-4}
OPENS_STEP_SPANS = False
CONTROLS = common.TRAINING_CONTROLS


def make_weights(cfg, seed, device):
    g = torch.Generator(device).manual_seed(common.stream(seed, 31))
    shapes = {"0.weight": (cfg["hidden"], cfg["in_features"]),
              "0.bias": (cfg["hidden"],),
              "2.weight": (cfg["out_features"], cfg["hidden"]),
              "2.bias": (cfg["out_features"],)}
    return {k: 0.5 * torch.randn(s, generator=g, device=device)
            for k, s in shapes.items()}


class Session:
    def __init__(self, cell, seed, device, trace, tamper=None):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device, self.batch = cell, device, traffic["batch"]
        self.subwindow_units = tuple(traffic["subwindow_units"])
        g = torch.Generator(device).manual_seed(common.stream(seed, 30))
        x = torch.randn((traffic["pool"], self.batch, cfg["in_features"]),
                        generator=g, device=device)
        y = torch.randn((traffic["pool"], self.batch, cfg["out_features"]),
                        generator=g, device=device)
        self.batches = list(zip(x, y))
        self.weights = make_weights(cfg, seed, device)
        self.net = torch.nn.Sequential(
            torch.nn.Linear(cfg["in_features"], cfg["hidden"]),
            torch.nn.Tanh(),
            torch.nn.Linear(cfg["hidden"], cfg["out_features"])).to(device)
        self.net.load_state_dict(self.weights)
        self.optimizer = torch.optim.Adam(self.net.parameters(), cfg["lr"])
        if tamper is not None:
            tamper(self)
        self.steps = 0
        self.losses = [float(self._step())
                       for _ in range(traffic["checked_steps"])]
        self.change = {k: v.detach() - self.weights[k]
                       for k, v in self.net.state_dict().items()}

    def train_step(self, x, y):
        self.optimizer.zero_grad()
        loss = torch.nn.functional.mse_loss(self.net(x), y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _step(self):
        x, y = self.batches[self.steps % len(self.batches)]
        loss = self.train_step(x, y)
        self.steps += 1
        return loss

    def window(self, seconds):
        start, t0 = self.steps, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
        harness.sync(self.device)
        elapsed, steps = time.perf_counter() - t0, self.steps - start
        return {"train_images_per_s": steps * self.batch / elapsed,
                "steps": steps, "seconds": elapsed, "attempted": steps,
                "failed": 0}

    def subwindow(self, units):
        for _ in range(units):
            self._step()

    def finish(self):
        harness.sync(self.device)

    def step_flops(self):
        c = self.cell.config
        return 6 * self.batch * c["hidden"] * (c["in_features"]
                                               + c["out_features"])

    def check(self):
        program = {"losses": self.losses, "change": self.change}
        reference = reference_readings(self.cell.config, self.weights,
                                       self.batches, len(self.losses))
        self.readings = {"program": program, "reference": reference}
        return gaps(program, reference)


def _operand(t, precision):
    if precision == "fp8":
        return t.float().to(torch.float8_e4m3fn).double()
    return t.double()


def reference_readings(cfg, weights, batches, steps, precision="float32",
                       batch_rows=None, lr=None):
    lr = cfg["lr"] if lr is None else lr
    p = {k: v.double() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for t in range(1, steps + 1):
        x, y = (a[:batch_rows].double() for a in batches[t - 1])
        w = {k: _operand(v, precision).detach().requires_grad_()
             for k, v in p.items()}
        h = torch.tanh(_operand(x, precision) @ w["0.weight"].T
                       + w["0.bias"])
        loss = ((h @ w["2.weight"].T + w["2.bias"] - y) ** 2).mean()
        grads = torch.autograd.grad(loss, list(w.values()))
        losses.append(float(loss.detach()))
        for k, g in zip(w, grads):
            m[k] = 0.9 * m[k] + 0.1 * g
            v2[k] = 0.999 * v2[k] + 0.001 * g * g
            p[k] = p[k] - lr * (m[k] / (1 - 0.9 ** t)) / (
                (v2[k] / (1 - 0.999 ** t)).sqrt() + 1e-8)
    return {"losses": losses,
            "change": {k: p[k] - weights[k].double() for k in p}}


def gaps(readings, reference):
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(readings["losses"], reference["losses"]))
    change = max(float((readings["change"][k].double() - r).norm()
                       / r.norm().clamp(min=1e-300))
                 for k, r in reference["change"].items())
    return {"toy_loss_gap": loss, "toy_change_gap": change}


def control_readings(session, control):
    return reference_readings(session.cell.config, session.weights,
                              session.batches, len(session.losses),
                              **common.training_control(control,
                                                        session.batch))


def _state_unchanged(session):
    common.drop_updates([session.optimizer])


def _half_batch(session):
    common.losses_on_half_batch(session, "train_step", torch.nn.functional,
                                ("mse_loss",))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}
'''


def _hashes() -> dict:
    """The SHA-256 of BENCHMARK.json and of every file under benchmark/
    (the interpreter's byte-code caches aside)."""
    files = [ROOT / "BENCHMARK.json"] + sorted(
        p for p in (ROOT / "benchmark").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)
    return {str(p.relative_to(ROOT)):
            hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def _with_toy(declared: dict) -> dict:
    """BENCHMARK.json as a change that adds the toy's cell would leave it:
    its configuration and cell appended, its name appended to the
    `workloads` of the metrics it reports."""
    declared = copy.deepcopy(declared)
    declared["configs"].append(CONFIG)
    declared["workloads"].append(WORKLOAD)
    for m in declared["end_to_end"] + declared["per_layer"]:
        if m["name"] in REPORTS:
            m["workloads"].append(CELL)
    return declared


@pytest.fixture(scope="module")
def before() -> dict:
    return _hashes()


@pytest.fixture(scope="module")
def toy_root(before, tmp_path_factory):
    """A benchmark's root with the toy's files beside copies of the data
    files and readers, the toy's entry loaded as `benchmark.entries.toy_mlp`
    (where the harness imports an entry from) for the module's tests."""
    root = tmp_path_factory.mktemp("toy_benchmark")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, root / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for rel, content in FILES.items():
        (root / "benchmark" / rel).write_text(json.dumps(content))
    path = root / "benchmark" / "entries" / f"{ENTRY}.py"
    path.parent.mkdir()
    path.write_text(TOY_ENTRY)
    (root / "BENCHMARK.json").write_text(json.dumps(_with_toy(bench())))
    spec = importlib.util.spec_from_file_location(
        f"benchmark.entries.{ENTRY}", path)
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, spec.name, module)
        spec.loader.exec_module(module)
        yield root


def test_toy_has_the_contract_form(toy_root):
    contract_form(toy_root)
    span_metrics_declared(toy_root)
    entry_contract(CELL, toy_root)
    entry = entry_of(CELL, toy_root)
    assert tuple(entry.FAULTS) == FAULTS
    others = {name for cell in cells()
              for name in entry_of(cell).FLOAT32_GAPS}
    assert not set(entry.FLOAT32_GAPS) & others  # check names of its own


@pytest.mark.parametrize("trace", [False, True])
def test_toy_runs_and_holds_to_the_reference(toy_root, trace):
    holds_to_the_reference(CELL, trace, toy_root)


@pytest.mark.parametrize("fault", FAULTS)
def test_toy_planted_fault_is_not_correct(toy_root, fault):
    fault_is_not_correct(CELL, fault, toy_root)


def test_toy_controls_are_not_correct(toy_root):
    controls_are_not_correct(CELL, toy_root)


def test_no_file_of_the_benchmark_changed(toy_root, before):
    """Last in the module: the toy's cell needed no edit of a file."""
    assert _hashes() == before
