"""The yardstick's own arithmetic on the CPU: the trace join, byte and FLOP
counts and idle gaps on a hand-written trace; the per-layer readers on it;
the reference step's FLOP count against a hand count; the inputs' and
weights' dependence on the seed alone; BENCHMARK.json's form."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from benchmark import harness, peaks, traffic
from benchmark import trace as tr
from benchmark.entries import finetune, gan_train
from benchmark.reference import gan as ref_gan
from benchmark.tests.conftest import ROOT, SEED, small_cell
from benchmark.weights import make_weights

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _cpu(name, ts, dur, ext, dims=(), types=(), tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"External id": ext,
                                           "Input Dims": list(dims),
                                           "Input type": list(types)}}


def _kernel(name, ts, dur, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"External id": ext}}


BF16 = "c10::BFloat16"
TRACE = [
    {"ph": "X", "cat": "user_annotation", "name": "bench:train_step",
     "ts": 0, "dur": 100, "pid": 1, "tid": 1},
    # a max pool (Kernel 2): (2, 4, 8, 8) bf16 in, a quarter out
    _cpu("spig::max_pool_2x2", 1, 10, 11, [[2, 4, 8, 8]], [BF16]),
    _kernel("max_pool_2x2_kernel", 20, 4, 11),
    # the attention (Kernel 1): q (2, 16, 2), k (2, 4, 2), v (2, 4, 8)
    _cpu("spig::pooled_kv_attention", 30, 10, 12,
         [[2, 16, 2], [2, 4, 2], [2, 4, 8]], [BF16] * 3),
    _kernel("attention_mma_kernel", 40, 2, 12),
    # a conv's bias add under aten::conv2d, not a port kernel
    _cpu("aten::conv2d", 45, 25, 13, [[2, 4, 8, 8], [4, 4, 3, 3], [4]],
         [BF16] * 3),
    _cpu("aten::add_", 55, 5, 14, [[2, 4, 8, 8], [4]], [BF16] * 2),
    _kernel("vectorized_elementwise_kernel", 60, 10, 14),
    _cpu("aten::copy_", 80, 10, 15, [[2], [2]], ["float", "float"]),
    _kernel("Memcpy DtoH", 90, 5, 15),
]


def test_join_climbs_to_the_outermost_op():
    ops = tr.op_trees(TRACE)
    assert tr.row_op(ops[14]).name == "aten::conv2d"
    assert tr.row_op(ops[11]).name == "spig::max_pool_2x2"


def test_bytes_and_flops_of_the_port_kernels():
    ops = tr.op_trees(TRACE)
    n = 2 * 4 * 8 * 8
    assert tr.op_bytes(ops[11]) == 2 * n + 2 * n // 4
    attention = ops[12]
    assert tr.attention_flops(attention) == 2 * 2 * 16 * 4 * (2 + 8)
    assert tr.op_bytes(attention) == 2 * (2 * 16 * 2 + 2 * 4 * 2 + 2 * 4 * 8
                                          + 2 * 16 * 8)
    assert peaks.op_peak(attention) == peaks.FLOPS["bfloat16"]


def test_busy_gaps_and_top_ops():
    device = tr.device_events(TRACE)
    assert len(device) == 4
    assert tr.busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) == 21
    assert tr.device_span_us(TRACE) == 75
    assert tr.device_span_us(TRACE[:2]) == 0
    gaps = tr.idle_gaps(TRACE, 2)
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 18e-6])
    assert [g[0] for g in gaps] == ["train_step/python"] * 2
    inside = [TRACE[0], _cpu("aten::mul", 0, 5, 21), _kernel("k", 0, 1, 21),
              _kernel("k", 10, 1, 21)]
    (what, seconds), = tr.idle_gaps(inside, 1)
    assert what == "train_step/aten::mul" and seconds == pytest.approx(9e-6)
    (name, seconds), = tr.top_device_ops(TRACE, 1)
    assert name == "vectorized_elementwise_kernel"
    assert seconds == pytest.approx(10e-6)


def _record(**window):
    cell = small_cell("sp-gan-256.train-b128")
    sub = {"events": TRACE, "seconds": 100e-6, "units": 2,
           "span": tr.device_span_us(TRACE) * 1e-6}
    return harness.RunRecord(cell, window, sub, sub, lambda: 10 ** 9, True)


def test_readers_on_the_hand_written_trace():
    record = _record(steps=4, seconds=2.0)
    read = lambda name: harness.load_reader(ROOT / "benchmark", name)(record)  # noqa: E731
    n = 2 * 4 * 8 * 8
    least = max((2 * n + 2 * n // 4) / peaks.HBM_BYTES_PER_S, 0.0) + max(
        tr.op_bytes(tr.op_trees(TRACE)[12]) / peaks.HBM_BYTES_PER_S,
        2 * 2 * 16 * 4 * 10 / peaks.FLOPS["bfloat16"])
    assert read("kernels_roofline") == pytest.approx(100 * least / 6e-6)
    # device ops from 20 to 95 us, 21 of them busy
    assert read("device_idle_pct.train") == pytest.approx(100 * (1 - 21 / 75))
    assert read("step_mfu_pct") == pytest.approx(
        100 * 1e9 * 4 / 2.0 / peaks.FLOPS["float32"])


def test_readers_find_nothing_without_work():
    empty = {"events": [], "seconds": 1.0, "units": 1, "span": 0.0}
    record = harness.RunRecord(small_cell("sp-gan-256.train-b128"),
                               {}, empty, empty, lambda: None, False)
    for name in ("kernels_roofline", "device_idle_pct.train",
                 "step_mfu_pct"):
        assert harness.load_reader(ROOT / "benchmark", name)(record) is None


def test_finetune_step_flops_by_hand():
    cfg = small_cell("vgg16-places365.finetune-b256").config
    rows, w = 3, ref_gan.Widths(cfg)
    s, cin, convs = cfg["image_size"], 3, []
    for item in w.vgg_plan:
        if item == "M":
            s //= 2
        else:
            convs.append(2 * rows * s * s * cin * item * 9)
            cin = item
    dense = [2 * rows * a * b for a, b in ((cin * 49, w.fc7), (w.fc7, w.fc7),
                                           (w.fc7, w.num_classes))]
    expected = 3 * (sum(convs) + sum(dense)) - convs[0]  # no input gradient
    assert finetune.reference_step_flops(cfg, rows) == expected


def test_gan_step_flops_exceed_the_forwards():
    cfg = small_cell("sp-gan-256.train-b128").config
    assert gan_train.reference_step_flops(cfg, 4) > 0


def test_inputs_and_weights_follow_the_seed():
    cell = small_cell("sp-gan-256.train-b128")
    cpu = torch.device("cpu")
    a = traffic.gan_batches(cell.config, cell.traffic, SEED, cpu)
    b = traffic.gan_batches(cell.config, cell.traffic, SEED, cpu)
    c = traffic.gan_batches(cell.config, cell.traffic, SEED + 1, cpu)
    assert all(np.array_equal(x["images"], y["images"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["images"], c[0]["images"])
    rows = np.concatenate([x["images"].reshape(len(x["images"]), -1)
                           for x in a])
    assert len(np.unique(rows, axis=0)) == len(rows)  # every row differs
    for masks in (x["masks"] for x in a):
        assert [m.shape[1:] for m in masks] == traffic.pyramid_shapes(
            cell.config)
    spec = ref_gan.generator_spec(ref_gan.Widths(cell.config))
    w1, w2 = (make_weights(spec, SEED, cpu) for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in spec)
    u = w1["final_block.3.weight_u"]
    assert float(u.norm()) == pytest.approx(1.0, abs=1e-6)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == (
            c["reduced"])
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "layer" in m:
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
            layers.setdefault(m["layer"], set()).add(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [w["name"] for w in BENCH["workloads"]]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
        reports = [m for m in BENCH["end_to_end"]
                   if w["name"] in m.get("workloads", names)]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            assert cell in names
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert cell in moved.get("workloads", names)
