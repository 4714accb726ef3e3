"""The phase-span readers (spans.py and the seven `metrics/` files that use
it) on a hand-written trace: device operations put down to the innermost
span open at their launch, on any thread; idle gaps to the span open at
their start; exact launch counts; the per-phase device times within the
busy time; the accepted readers blind to the spans; BENCHMARK.json's seven
entries, each reported by exactly the cells whose entry opens the program's
`sp:step` spans."""

from __future__ import annotations

import pytest

from benchmark import harness, spans
from benchmark import trace as tr
from benchmark.tests.conftest import ROOT, bench, cells, entry_of, small_cell
from benchmark.tests.test_bench_yardstick import TRACE as ACCEPTED_TRACE

CELLS = cells()
UNITS = 2
NEW = {"device_ms.to_device": ("ms", "train loop"),
       "idle_ms.loop": ("ms", "train loop"),
       "device_ms.forward": ("ms", "modules"),
       "device_ms.backward": ("ms", "modules"),
       "device_ms.adam": ("ms", "train step"),
       "launches.step": ("launches", "train step"),
       "idle_ms.step": ("ms", "train step")}


def _span(name, ts, dur, cat="user_annotation"):
    host = cat == "user_annotation"
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1 if host else 0, "tid": 1 if host else 7}


def _cpu(name, ts, dur, ext, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"External id": ext}}


def _device(name, ts, dur, ext, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"External id": ext}}


SPANS = [
    _span("bench:train_step", 0, 105),
    _span("sp:loop.to_device", 0, 12),
    _span("sp:step", 12, 88),
    _span("sp:step.g_phase.forward", 13, 27),
    _span("sp:step.g_phase.backward", 40, 40),
    _span("sp:step.g_phase.adam", 80, 15),
]
# the device timeline's twins of the spans, which no reader may count
GPU_SPANS = [_span("sp:step", 5, 99, "gpu_user_annotation"),
             _span("sp:step.g_phase.backward", 42, 18, "gpu_user_annotation")]
TRACE = SPANS + GPU_SPANS + [
    _cpu("aten::copy_", 2, 5, 21),
    _device("Memcpy HtoD (Pageable -> Device)", 5, 4, 21, "gpu_memcpy"),
    # a pageable copy's interval starts before the one ahead of it ends:
    # 1 us of its 4 adds to the busy time
    _cpu("aten::copy_", 8, 3, 28),
    _device("Memcpy HtoD (Pageable -> Device)", 6, 4, 28, "gpu_memcpy"),
    _cpu("aten::mul", 15, 3, 22),
    _device("mul_kernel", 20, 10, 22),
    _cpu("aten::div", 18, 2, 29),
    _device("div_kernel", 32, 2, 29),
    # the main thread in the backward span launches one kernel...
    _cpu("aten::add", 41, 2, 23),
    _device("add_kernel", 42, 3, 23),
    # ...and the autograd engine's thread another, under its own op
    _cpu("autograd::engine::evaluate_function: MulBackward0", 45, 20, 30,
         tid=2),
    _cpu("aten::mul", 46, 5, 24, tid=2),
    _device("mul_backward_kernel", 50, 10, 24),
    _cpu("aten::_foreach_add_", 82, 4, 25),
    _device("multi_tensor_apply_kernel", 85, 5, 25),
    # under sp:step and no phase: the step's own
    _cpu("aten::fill_", 97, 1, 26),
    _device("fill_kernel", 98, 1, 26, "gpu_memset"),
    # no launcher in the trace, and a launch under no span of the program
    _device("orphan_kernel", 101, 2, 99),
    _cpu("aten::zero_", 102, 1, 27),
    _device("zero_kernel", 103, 1, 27),
]
# device intervals [5,9] [6,10] [20,30] [32,34] [42,45] [50,60] [85,90]
# [98,99] [101,103] [103,104], 39 us busy; gaps at 10 (10), 30 (2), 34 (8),
# 45 (5), 60 (25), 90 (8), 99 (2)


def _record(events, on_card=True):
    sub = {"events": events, "seconds": 1e-4, "units": UNITS,
           "span": tr.device_span_us(events) * 1e-6}
    return harness.RunRecord(small_cell(CELLS[0]), {}, sub, sub,
                             lambda: None, on_card)


def _read(name, record):
    return harness.load_reader(ROOT / "benchmark", name)(record)


def test_backward_launched_from_another_thread_and_innermost_span():
    split = spans.split(TRACE)
    assert split.device_us == {"loop.to_device": 4 + 1,
                               "step.g_phase.forward": 12,
                               "step.g_phase.backward": 13,
                               "step.g_phase.adam": 5, "step": 1}
    assert split.launches == {"loop.to_device": 2, "step.g_phase.forward": 2,
                              "step.g_phase.backward": 2,
                              "step.g_phase.adam": 1, "step": 1}
    assert _read("device_ms.backward", _record(TRACE)) == pytest.approx(
        13e-3 / UNITS)
    assert spans.innermost(spans.host_spans(TRACE), 46) == (
        "step.g_phase.backward")
    assert spans.innermost(spans.host_spans(TRACE), 102) is None


def test_gaps_go_to_the_span_open_at_their_start():
    assert spans.split(TRACE).idle_us == {
        "loop.to_device": 10, "step.g_phase.forward": 10,
        "step.g_phase.backward": 30, "step.g_phase.adam": 8, "step": 2}
    record = _record(TRACE)
    assert _read("idle_ms.loop", record) == pytest.approx(10e-3 / UNITS)
    assert _read("idle_ms.step", record) == pytest.approx(
        (10 + 30 + 8 + 2) * 1e-3 / UNITS)


def test_launches_step_counts_exactly():
    assert _read("launches.step", _record(TRACE)) == (2 + 2 + 1 + 1) / UNITS


def test_phase_device_times_within_the_busy_time():
    record = _record(TRACE)
    values = {name: _read(name, record) for name in (
        "device_ms.to_device", "device_ms.forward", "device_ms.backward",
        "device_ms.adam")}
    assert values == pytest.approx({
        "device_ms.to_device": 5e-3 / UNITS,
        "device_ms.forward": 12e-3 / UNITS,
        "device_ms.backward": 13e-3 / UNITS, "device_ms.adam": 5e-3 / UNITS})
    busy_ms_per_step = harness.busy_seconds(record.shapes) * 1e3 / UNITS
    assert busy_ms_per_step == pytest.approx(39e-3 / UNITS)
    assert sum(values.values()) <= busy_ms_per_step
    split = spans.split(TRACE)
    assert sum(split.device_us.values()) <= 39  # every span's, and no more
    # what no phase holds: the step's own fill and the two unclaimed ones
    assert busy_ms_per_step - sum(values.values()) == pytest.approx(
        4e-3 / UNITS)


def test_accepted_readers_do_not_see_the_spans():
    plain = ACCEPTED_TRACE
    spanned = plain + [
        _span("sp:step", 0, 100), _span("sp:step.g_phase.forward", 25, 50),
        _span("sp:step", 18, 80, "gpu_user_annotation"),
        _span("sp:step.g_phase.forward", 38, 30, "gpu_user_annotation")]
    a, b = _record(plain), _record(spanned)
    for name in ("kernels_roofline", "device_idle_pct.train"):
        assert _read(name, a) == _read(name, b) is not None
    assert tr.idle_gaps(plain, 10) == tr.idle_gaps(spanned, 10)
    assert tr.top_device_ops(plain, 10) == tr.top_device_ops(spanned, 10)
    assert harness.busy_seconds(a.device) == harness.busy_seconds(b.device)
    assert tr.device_span_us(plain) == tr.device_span_us(spanned)
    # and the spans' readers find the spans there
    assert _read("device_ms.forward", b) == pytest.approx(
        (2 + 10) * 1e-3 / UNITS)


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_off_the_card_and_without_spans(name):
    assert _read(name, _record(TRACE, on_card=False)) is None
    assert _read(name, _record(ACCEPTED_TRACE)) is None  # the parent's trace
    assert _read(name, _record(TRACE)) is not None


def span_metrics_declared(root=ROOT) -> None:
    """The seven entries of `root`/BENCHMARK.json, each reported by the
    cells whose entry opens the spans, and by no other."""
    declared = bench(root)
    opening = [c for c in cells(root) if entry_of(c, root).OPENS_STEP_SPANS]
    entries = {m["name"]: m for m in declared["per_layer"]}
    for name, (unit, layer) in NEW.items():
        m = entries[name]
        assert m == {"name": name, "unit": unit, "better": "lower",
                     "source": "device_trace", "layer": layer,
                     "moves": "train_images_per_s", "workloads": opening}
        assert (root / "benchmark" / "metrics" / f"{name}.py").exists()
    names = [m["name"] for m in declared["per_layer"]]
    first = names.index(next(iter(NEW)))  # together, in this order
    assert names[first:first + len(NEW)] == list(NEW)


def test_benchmark_json_has_the_seven_span_metrics():
    span_metrics_declared()
