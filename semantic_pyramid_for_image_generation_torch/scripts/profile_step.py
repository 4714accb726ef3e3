"""Profile the fused train step on the card and report a per-op roofline:
the counterpart of the repository's scripts/profile_step.py for the PyTorch
port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.profile_step \
        [--batch 128] [--steps 3] [--warmup 2] [--dtype bfloat16] \
        [--keep | --log_dir DIR [--analyze_only]] [--device cuda]

`capture` builds the full-width state (PyramidGANConfig, `init_train_state`
with its two Adams, `make_train_step`, one `synthetic_batch` on the device),
runs `--warmup` steps, counts one step's FLOPs under
`torch.utils.flop_counter.FlopCounterMode`, times UNPROFILED_WINDOWS windows
of `--steps` queued steps without the profiler, then runs `--steps` steps
under `torch.profiler` (CPU and CUDA activities, shapes recorded, one
synchronize at the end). It writes the chrome trace (`trace.json`) and its
own readings (`capture.json`) into the log directory.

`analyze` reads them back (so `--analyze_only` re-reads a kept `--log_dir`)
and returns one report: the device time per step, the share of each op
category, the top 20 ops with each one's FLOP rate, bandwidth and what bounds
it, the data-formatting kernels, the elementwise ops, the CPU ops that
launched the most device time (summed over the ops they ran under), each
port kernel's
launches per step, the step's FLOPs and its share of the card's peak. The
report prints as one JSON document; the trace lands in a temporary directory
unless `--keep` or `--log_dir` is given.

What it counts:
  * a device op is a kernel, memcpy or memset event of the trace; its
    category comes from its name (OP_KINDS, first match), "other" else;
  * an op (a row) is the outermost aten or spig op above the CPU op that
    launched the device op (joined through the trace's `External id`),
    keyed by name, input shapes and input types; its time is the device time
    of every device op it launched, its category that of the device ops
    that took most of it, and `kernels` its three longest device ops with
    the CPU op that launched each (a convolution's bias add is an
    `aten::add_` under `aten::conv2d`);
  * an op's FLOPs follow torch.utils.flop_counter's formulas from the
    recorded shapes (conv forward and backward, mm, addmm, bmm, baddbmm),
    summed over the op's sub-ops; the spig custom ops (the port's kernels)
    carry none;
  * an op's bytes are its tensor inputs read once and its output written
    once, the output worked out from the shapes (`output_bytes`; the inputs'
    broadcast shape for the rest, a TensorList element counted as float32);
  * an op's bound is the larger of its FLOPs at PEAK_FLOPS (by its first
    input's dtype) and its bytes at HBM_BYTES_PER_S: NVIDIA's H100 SXM data;
  * `step_flops` is the model's work in one step, not the implementation's:
    convolutions, dense layers, matmuls and the attention's two products (a
    formula for `spig::pooled_kv_attention`); `step_mfu_pct` is it over the
    profiled wall time per step at the dtype's peak, and
    `step_mfu_pct_unprofiled` over the unprofiled median (the profiler's
    overhead inflates the wall time). With --device cpu there is no card:
    the MFUs are null and every device-time key reads 0.

The JAX report's `loop_fusion_ops` is `elementwise_ops` here: the card runs
no XLA fusions, each elementwise op is its own kernel.
"""

from __future__ import annotations

import argparse
import ast
import collections
import json
import math
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_train_step,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    resolve_device,
)

TRACE, CAPTURE = "trace.json", "capture.json"
UNPROFILED_WINDOWS = 3  # windows of --steps queued steps, median per step
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOP_N, FORMATTING_N, ELEMENTWISE_N = 20, 12, 10  # rows per list

# the port's kernels: custom op -> its CUDA kernels' names (csrc/)
PORT_KERNELS = {
    "pooled_kv_attention": ("attention_mma_kernel", "attention_fp32_kernel"),
    "max_pool_2x2": ("max_pool_2x2_kernel",),
    "upsample_2x": ("upsample_2x_kernel",),
    "max_pool_2x2_backward": ("max_pool_2x2_backward_kernel",),
    "upsample_2x_backward": ("upsample_2x_backward_kernel",),
    "batch_norm_stats": ("batch_norm_stats_kernel",),
    "batch_norm_apply": ("batch_norm_apply_kernel",),
    "batch_norm_backward_sums": ("batch_norm_backward_sums_kernel",),
    "batch_norm_backward_dx": ("batch_norm_backward_dx_kernel",),
}
KERNEL_NAMES = tuple(n for names in PORT_KERNELS.values() for n in names)
# device op categories by name, first match wins
OP_KINDS = (
    ("port kernels", KERNEL_NAMES),
    ("optimizer", ("multi_tensor_apply", "foreach", "fused_adam")),
    ("convolution", ("xmma", "conv", "cudnn", "fft", "FFT", "implicit_gemm",
                     "wgrad", "dgrad", "nhwcToNchw", "nchwToNhwc",
                     "pointwise_mult_and_sum_complex")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "Kernel2")),
    ("copies", ("Memcpy", "Memset", "copy_kernel", "direct_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "index", "scatter",
                     "gather", "where")),
)
# device ops that only move or re-lay data: layout transposes, copies, casts
FORMATTING_KERNELS = ("nchwToNhwc", "nhwcToNchw", "Memcpy", "Memset",
                      "copy_kernel", "direct_copy")
FORMATTING_OPS = ("aten::copy_", "aten::to", "aten::_to_copy", "aten::clone",
                  "aten::contiguous", "aten::type_as")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
               "long int": 8, "int": 4, "short int": 2, "signed char": 1,
               "unsigned char": 1, "bool": 1}
SCALAR_TYPE_BYTES = {0: 1, 1: 1, 2: 2, 3: 4, 4: 8, 5: 2, 6: 4, 7: 8, 11: 1,
                     15: 2}  # c10::ScalarType codes of a `to(dtype)`
REDUCTIONS = ("sum", "mean", "amax", "amin", "max", "min", "norm",
              "linalg_vector_norm", "var_mean", "var", "std", "argmax",
              "any", "all", "_foreach_norm")


def category(name: str) -> str:
    return next((kind for kind, keys in OP_KINDS
                 if any(key in name for key in keys)), "other")


# ------------------------------------------------------------- capture --

def attention_flops(q_shape, k_shape, v_shape, out_shape=None,
                    **kwargs) -> int:
    """softmax(q k^T) v: the two products, 2 B Nq Nk (C8 + C2)."""
    b, nq, c8 = q_shape
    return 2 * b * nq * k_shape[1] * (c8 + v_shape[2])


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of `fn` under FlopCounterMode: torch's formulas for
    convolutions and products, `attention_flops` for the port's attention
    kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.spig.pooled_kv_attention: attention_flops})
    with counter:
        fn()
    return counter.get_total_flops()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture(args, log_dir: str,
            config: Optional[PyramidGANConfig] = None) -> None:
    """Run and profile the step (see the module docstring); `config`
    defaults to the full width at --dtype."""
    device = resolve_device(args.device)
    config = config or PyramidGANConfig(compute_dtype=args.dtype)
    state = init_train_state(config, device)
    step = make_train_step()
    batch = batch_to_device(
        synthetic_batch(config, args.batch, np.random.default_rng(0)), device)
    rng = torch.Generator(device).manual_seed(1)

    def walk() -> float:
        """--steps steps queued, one synchronize and one fetch: seconds."""
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, metrics = step(state, batch, rng)
        _sync(device)
        loss = float(metrics["loss_generator"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss_generator {loss}")
        return time.perf_counter() - t0

    for _ in range(args.warmup):
        step(state, batch, rng)
    _sync(device)
    step_flops = count_flops(lambda: step(state, batch, rng))
    unprofiled = statistics.median(walk() for _ in range(UNPROFILED_WINDOWS))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
        wall = walk()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE))
    with open(os.path.join(log_dir, CAPTURE), "w") as f:
        json.dump({"batch": args.batch, "dtype": config.compute_dtype,
                   "steps": args.steps, "warmup": args.warmup,
                   "wall_us_per_step": wall * 1e6 / args.steps,
                   "unprofiled_us_per_step": unprofiled * 1e6 / args.steps,
                   "step_flops": step_flops,
                   "card": card_line() if device.type == "cuda" else "cpu"},
                  f)


# ------------------------------------------------------------- analyze --

class Op:
    """A CPU op of the trace and the ops it called."""

    def __init__(self, event: dict):
        self.name: str = event["name"]
        self.args: dict = event.get("args", {})
        self.start, self.end = event["ts"], event["ts"] + event.get("dur", 0)
        self.parent: Optional[Op] = None
        self.children: List[Op] = []

    def tensors(self) -> List[tuple]:
        """(shape, bytes per element) of each tensor input; a TensorList's
        elements count float32."""
        out = []
        for dims, kind in zip(self.args.get("Input Dims", []),
                              self.args.get("Input type", [])):
            if kind in DTYPE_BYTES:
                out.append((list(dims), DTYPE_BYTES[kind]))
            elif kind == "TensorList":
                out += [(list(d), 4) for d in dims]
        return out

    def concrete(self, i: int):
        """The i-th recorded scalar argument, parsed; None if absent."""
        values = self.args.get("Concrete Inputs", [])
        try:
            return ast.literal_eval(values[i])
        except (IndexError, ValueError, SyntaxError):
            return None

    def key(self) -> tuple:
        return (self.name, json.dumps(self.args.get("Input Dims", [])),
                json.dumps(self.args.get("Input type", [])))


def _op_trees(events: List[dict]) -> Dict[int, Op]:
    """Nest the CPU ops of each thread by their intervals; {External id:
    op}."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    ops = {}
    for thread in by_thread.values():
        stack: List[Op] = []
        for e in sorted(thread, key=lambda e: (e["ts"], -e.get("dur", 0))):
            op = Op(e)
            while stack and stack[-1].end <= op.start:
                stack.pop()
            if stack:
                op.parent = stack[-1]
                stack[-1].children.append(op)
            stack.append(op)
            ops.setdefault(e.get("args", {}).get("External id"), op)
    return ops


def _row_op(op: Op) -> Op:
    """The outermost aten / spig op of the chain that called `op`."""
    while op.parent is not None and op.parent.name.startswith(
            ("aten::", "spig::")):
        op = op.parent
    return op


# conv forward ops; their Concrete Inputs hold stride, padding and
# dilation at 3, 4 and 5
CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution")


def _conv_out(op: Op) -> list:
    """The output shape of a CONV_OPS op (stride 1, padding 0, dilation 1
    where not recorded)."""
    (x, _), (w, _) = op.tensors()[:2]
    stride, padding, dilation = (
        op.concrete(i) if op.concrete(i) is not None else default
        for i, default in ((3, 1), (4, 0), (5, 1)))
    size = []
    for d in range(2):
        s, p, dl = (v[d] if isinstance(v, list) else v
                    for v in (stride, padding, dilation))
        size.append((x[2 + d] + 2 * p - dl * (w[2 + d] - 1) - 1) // s + 1)
    return [x[0], w[0]] + size


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def op_flops(op: Op) -> int:
    """torch.utils.flop_counter's count of `op` from its recorded shapes;
    an op without a formula sums its sub-ops'."""
    from torch.utils.flop_counter import conv_flop_count

    name, t = op.name, [s for s, _ in op.tensors()]
    if name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
        a, b = t[-2:]
        return 2 * _numel(a) * b[-1]
    if name in CONV_OPS:
        return conv_flop_count(t[0], t[1], _conv_out(op))
    if name == "aten::convolution_backward":
        mask = op.concrete(10) or [True, True, False]
        return conv_flop_count(t[1], t[2], t[0]) * (int(mask[0])
                                                    + int(mask[1]))
    return sum(op_flops(child) for child in op.children)


def _einsum_out(op: Op) -> Optional[list]:
    equation = op.concrete(0)
    if not isinstance(equation, str) or "->" not in equation:
        return None
    inputs, out = equation.replace(" ", "").split("->")
    sizes = {}
    for letters, (shape, _) in zip(inputs.split(","), op.tensors()):
        sizes.update(zip(letters, shape))
    return [sizes.get(c, 1) for c in out]


def output_bytes(op: Op) -> int:
    """The bytes `op` writes, worked out from its recorded inputs."""
    t = op.tensors()
    short = op.name.split("::")[-1]
    if not t:
        size = op.concrete(0)  # a factory: randn(size), zeros(size), ...
        return _numel(size) * 4 if isinstance(size, list) else 0
    (first, width), shapes = t[0], [s for s, _ in t]
    if short in ("copy_",) + REDUCTIONS:
        return 0  # copy_: its destination is an input; reductions: small
    if short.startswith("_foreach_"):  # one list written, first list's shapes
        lists = [d for d, kind in zip(op.args["Input Dims"],
                                      op.args["Input type"])
                 if kind == "TensorList"]
        return 4 * sum(_numel(s) for s in lists[0])
    if short.endswith("_"):  # in place: the first input is written
        return _numel(first) * width
    if op.name in CONV_OPS:
        return _numel(_conv_out(op)) * width
    if short == "convolution_backward":
        mask = op.concrete(10) or [True, True, False]
        _, x, w = shapes[:3]
        return width * (mask[0] * _numel(x) + mask[1] * _numel(w)
                        + mask[2] * w[0])
    if short == "linear":
        return _numel(shapes[0][:-1]) * shapes[1][0] * width
    if short in ("mm", "addmm", "bmm", "baddbmm", "matmul"):
        a, b = shapes[-2:]
        return _numel(a[:-1]) * b[-1] * width
    if short == "einsum":
        out = _einsum_out(op)
        return _numel(out) * width if out else 0
    if short in ("to", "_to_copy", "type_as"):
        return _numel(first) * SCALAR_TYPE_BYTES.get(op.concrete(1), width)
    if short == "upsample_2x":
        return 4 * _numel(first) * width
    if short in ("upsample_2x_backward", "max_pool_2x2"):
        return _numel(first) // 4 * width
    if short == "max_pool_2x2_backward":
        return _numel(first) * width
    if short == "pooled_kv_attention":
        q, _, v = shapes
        return q[0] * q[1] * v[2] * width
    try:  # elementwise: the inputs' broadcast shape
        return _numel(np.broadcast_shapes(*map(tuple, shapes))) * width
    except ValueError:
        return _numel(first) * width


def op_bytes(op: Op) -> int:
    return sum(_numel(s) * w for s, w in op.tensors()) + output_bytes(op)


def _peak(op: Op) -> float:
    kinds = [k for k in op.args.get("Input type", []) if k in DTYPE_BYTES]
    return PEAK_FLOPS["bfloat16" if kinds and kinds[0] in (
        "c10::BFloat16", "c10::Half") else "float32"]


def _busy_us(intervals: List[tuple]) -> float:
    """The union of the device ops' intervals."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def analyze(log_dir: str, steps: int) -> dict:
    """The report (see the module docstring) from `log_dir`'s trace and, when
    there, its capture readings."""
    with open(os.path.join(log_dir, TRACE)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    meta = {}
    if os.path.exists(os.path.join(log_dir, CAPTURE)):
        with open(os.path.join(log_dir, CAPTURE)) as f:
            meta = json.load(f)
    ops = _op_trees(events)
    device = [e for e in events if str(e.get("cat", "")).lower()
              in DEVICE_EVENTS]
    total_us = sum(e.get("dur", 0) for e in device)
    by_category = collections.Counter()
    rows: Dict[tuple, dict] = {}
    formatting: Dict[tuple, dict] = {}
    launches = collections.Counter()
    launchers = collections.Counter()
    for e in device:
        name, dur = e["name"], e.get("dur", 0)
        kind = category(name)
        by_category[kind] += dur
        for kernel, symbols in PORT_KERNELS.items():
            launches[kernel] += any(s in name for s in symbols)
        launcher = ops.get(e.get("args", {}).get("External id"))
        op = _row_op(launcher) if launcher is not None else None
        key = op.key() if op is not None else ("(no op)", name, "")
        row = rows.setdefault(key, {"op": op, "name": key[0], "us": 0.0,
                                    "instances": {}, "kernels":
                                    collections.Counter(), "kinds":
                                    collections.Counter()})
        row["us"] += dur
        launched_by = launcher.name if launcher is not None else None
        row["kernels"][(launched_by, name)] += dur
        launchers[(launched_by, key[0])] += dur
        row["kinds"][kind] += dur
        if op is not None:
            row["instances"][id(op)] = op
        if any(k in name for k in FORMATTING_KERNELS) or (
                op is not None and op.name in FORMATTING_OPS):
            f_row = formatting.setdefault((name, key), {
                "op": name[:80], "within": key[0],
                "shapes": op.args.get("Input Dims") if op is not None
                else None, "n": 0, "us": 0.0, "category": kind})
            f_row["n"] += 1
            f_row["us"] += dur

    def share(us: float) -> float:
        return round(100 * us / max(total_us, 1e-9), 2)

    def fmt(row: dict) -> dict:
        instances = list(row["instances"].values())
        flops = sum(op_flops(op) for op in instances)
        moved = sum(op_bytes(op) for op in instances)
        seconds = row["us"] * 1e-6
        t_flops = flops / _peak(instances[0]) if instances else 0.0
        t_bytes = moved / HBM_BYTES_PER_S
        bound_s = max(t_flops, t_bytes)
        op = row["op"]
        return {
            "op": row["name"][:80],
            "shapes": op.args.get("Input Dims") if op is not None else None,
            "category": row["kinds"].most_common(1)[0][0],
            "n": len(instances),
            "self_us_per_step": round(row["us"] / steps, 1),
            "share_pct": share(row["us"]),
            "bound_by": (None if bound_s == 0 else "operations"
                         if t_flops > t_bytes else "bytes"),
            "bound_us_per_step": round(bound_s * 1e6 / steps, 1),
            "roofline_pct": (round(100 * bound_s / seconds, 1)
                             if seconds else None),
            "gflops_per_s": (round(flops / seconds / 1e9, 1)
                             if flops and seconds else None),
            "mem_bw_gib_s": (round(moved / seconds / 2 ** 30, 1)
                             if moved and seconds else None),
            "kernels": [{"kernel": kernel[:80], "launched_by": launcher,
                         "us_per_step": round(us / steps, 1)}
                        for (launcher, kernel), us in
                        row["kernels"].most_common(3)],
        }

    ordered = sorted(rows.values(), key=lambda r: -r["us"])
    busy = _busy_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device])
    wall = meta.get("wall_us_per_step")
    dtype = meta.get("dtype", "bfloat16")
    on_card = meta.get("card", "cpu") != "cpu"
    flops = meta.get("step_flops")

    def mfu(us_per_step):
        if not (on_card and flops and us_per_step):
            return None
        return round(100 * flops / (us_per_step * 1e-6) / PEAK_FLOPS[dtype], 2)

    return {
        "total_device_us_per_step": round(total_us / steps, 1),
        "category_shares_pct": {
            k: share(v) for k, v in by_category.most_common()},
        "top_ops": [fmt(r) for r in ordered[:TOP_N]],
        "data_formatting_ops": [
            {"op": r["op"], "within": r["within"], "shapes": r["shapes"],
             "category": r["category"], "n": r["n"],
             "self_us_per_step": round(r["us"] / steps, 1),
             "share_pct": share(r["us"])}
            for r in sorted(formatting.values(),
                            key=lambda r: -r["us"])[:FORMATTING_N]],
        "elementwise_ops": [fmt(r) for r in ordered if r["kinds"].most_common(
            1)[0][0] == "elementwise"][:ELEMENTWISE_N],
        "top_launchers": [
            {"launched_by": launched_by, "within": within,
             "us_per_step": round(us / steps, 1), "share_pct": share(us)}
            for (launched_by, within), us in launchers.most_common(TOP_N)],
        "wall_us_per_step": wall,
        "device_busy_pct": (round(100 * busy / (wall * steps), 2)
                            if wall else None),
        "launches_per_step": {
            k: launches[k] // steps if launches[k] % steps == 0
            else launches[k] / steps for k in PORT_KERNELS},
        "step_flops": flops,
        "step_mfu_pct": mfu(wall),
        "unprofiled_us_per_step": meta.get("unprofiled_us_per_step"),
        "step_mfu_pct_unprofiled": mfu(meta.get("unprofiled_us_per_step")),
        "batch": meta.get("batch"), "dtype": meta.get("dtype"),
        "card": meta.get("card"),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="profile the fused train step: a per-op roofline table "
                    "and the step's share of the card's peak")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--keep", action="store_true",
                   help="keep the trace dir (prints its path)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--analyze_only", action="store_true",
                   help="re-analyze an existing --log_dir without capturing")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        if not args.analyze_only:
            capture(args, args.log_dir)
        print(json.dumps(analyze(args.log_dir, args.steps), indent=1))
        return 0
    if args.keep:
        log_dir = tempfile.mkdtemp(prefix="profile_step_")
        capture(args, log_dir)
        print(json.dumps(analyze(log_dir, args.steps), indent=1))
        print("trace kept at", log_dir, file=sys.stderr)
        return 0
    with tempfile.TemporaryDirectory() as log_dir:
        capture(args, log_dir)
        print(json.dumps(analyze(log_dir, args.steps), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
