"""The cell-independent part of a run: finding a cell's files by name,
timing set-up and the window, the two profiled sub-windows of a traced run,
the per-layer readers, the comparison against the limits and the result
line.

An entry (`entries/<name>.py`, named by the traffic mix) supplies a
`Session(cell, seed, device, trace, tamper)` whose construction is the
set-up (the program built on the benchmark's weights, the checked first
steps or requests, the warm-up) and which has:
  * `window(seconds) -> dict`: the timed window; the end-to-end values under
    their metric names, `attempted`, `failed`, and what readers need;
  * `subwindow(units)`: that many units of the same work, for a profiler,
    with the window's fetch cadence and no fetch or synchronize of its own;
  * `subwindow_units`: (units traced for the device, units traced with
    shapes);
  * `step_flops() -> int | None`: the reference step's FLOPs at the cell's
    shapes;
  * `check() -> dict`: frees the program, runs the reference, returns the
    numbers compared by name.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark import trace as tr

BREAKDOWN_N = 10


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its data files."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench_dir = root / "benchmark"
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r}; have {sorted(workloads)}")
    w = workloads[name]
    config_file = next(c["file"] for c in bench["configs"]
                       if c["name"] == w["config"])
    with open(root / config_file) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                bench_dir)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(session, device: torch.device, units: int, shapes: bool
              ) -> dict:
    """`units` of the session's work under torch.profiler: the device's
    activity only, or the host's ops with their shapes as well. Returns the
    trace's complete events, the host seconds of the sub-window, and its
    `span`: the seconds from the first device operation's start to the last
    one's end, which leave out the synchronizes at the sub-window's edges."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if shapes or device.type != "cuda":
        activities.append(torch.profiler.ProfilerActivity.CPU)
    sync(device)
    with torch.profiler.profile(activities=activities,
                                record_shapes=shapes) as prof:
        sync(device)
        t0 = time.perf_counter()
        session.subwindow(units)
        sync(device)
        seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    finally:
        os.remove(path)
    return {"events": events, "seconds": seconds, "units": units,
            "span": tr.device_span_us(events) * 1e-6}


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads: the cell, the timed window's record,
    the device-only sub-window and the sub-window with shapes, the
    reference step's FLOPs, and whether the run was on the card (a CPU
    run's time is never read as a device metric)."""
    cell: Cell
    window: dict
    device: Optional[dict]
    shapes: Optional[dict]
    step_flops: Callable[[], Optional[int]]
    on_card: bool


def load_reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _finite(x) -> float:
    """A number compared, with a non-finite reading as the largest float
    (JSON has no infinity; it fails any limit)."""
    x = float(x)
    return x if math.isfinite(x) else sys.float_info.max


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, start: float,
             tamper: Optional[Callable] = None, config: Optional[dict] = None
             ) -> dict:
    """One run of `cell` (see the module docstring); `config` replaces the
    cell's configuration (the tests' small sizes), `tamper(session)` breaks
    the program before the checked steps (the tests' planted faults)."""
    if config is not None:
        cell = dataclasses.replace(cell, config=config)
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    session = entry.Session(cell, seed, device, trace, tamper)
    sync(device)
    setup_s = time.perf_counter() - start
    window = session.window(seconds)
    device_trace = shapes_trace = None
    if trace:
        units_device, units_shapes = session.subwindow_units
        device_trace = _profiled(session, device, units_device, shapes=False)
        shapes_trace = _profiled(session, device, units_shapes, shapes=True)
    session.finish()
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        record = RunRecord(cell, window, device_trace, shapes_trace,
                           session.step_flops, device.type == "cuda")
        for metric in cell.per_layer:
            value = load_reader(cell.bench_dir, metric["name"])(record)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value),
                                           "unit": metric["unit"]}
        breakdown = {
            "device_ops": tr.top_device_ops(device_trace["events"],
                                            BREAKDOWN_N),
            "idle_gaps": tr.idle_gaps(shapes_trace["events"], BREAKDOWN_N)}
    else:
        for metric in cell.end_to_end:
            value = (setup_s if metric["name"] == "setup_s"
                     else window.get(metric["name"]))
            if value is not None:
                metrics[metric["name"]] = {"value": float(value),
                                           "unit": metric["unit"]}
    numbers = session.check()
    del session
    gc.collect()
    checks = {name: {"value": _finite(numbers[name]),
                     "limit": float(limit)}
              for name, limit in cell.limits.items()}
    correct = window["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(window["attempted"]),
        "failed": int(window["failed"]),
        "metrics": metrics,
        "device": device_line(device, memory, device_trace),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def device_line(device: torch.device, memory: int,
                device_trace: Optional[dict]) -> dict:
    line = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(memory)}
    if device_trace is not None:
        line["busy_s"] = busy_seconds(device_trace)
        line["window_s"] = device_trace["span"]
    return line


def busy_seconds(sub: dict) -> float:
    """The seconds of a sub-window in which a device operation ran."""
    return tr.busy_us([(e["ts"], e["ts"] + e.get("dur", 0))
                       for e in tr.device_events(sub["events"])]) * 1e-6


def idle_pct(run: RunRecord) -> Optional[float]:
    """The share of the device-only sub-window's span (first device
    operation to last) in which no kernel and no copy ran; None without a
    device event."""
    busy = busy_seconds(run.device)
    if busy <= 0 or run.device["span"] <= 0:
        return None
    return 100.0 * (1.0 - busy / run.device["span"])


def free() -> None:
    """Collect garbage and return the cached device blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
