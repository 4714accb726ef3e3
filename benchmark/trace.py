"""The trace reading the per-layer metrics share: a frozen copy of the
program's `scripts/profile_step.py` join of device events to the CPU ops
that launched them (through the trace's `External id`, climbing to the
outermost aten / spig op), its FLOP and byte counts from the recorded
shapes, and the union of device intervals; plus the idle gaps between
device operations, named by the benchmark's span on the host.

Kept here so that a change to the program cannot change how its work is
counted.
"""

from __future__ import annotations

import ast
import collections
import json
import math
from typing import Dict, List, Optional

import numpy as np

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
               "long int": 8, "int": 4, "short int": 2, "signed char": 1,
               "unsigned char": 1, "bool": 1}
SCALAR_TYPE_BYTES = {0: 1, 1: 1, 2: 2, 3: 4, 4: 8, 5: 2, 6: 4, 7: 8, 11: 1,
                     15: 2}  # c10::ScalarType codes of a `to(dtype)`
REDUCTIONS = ("sum", "mean", "amax", "amin", "max", "min", "norm",
              "linalg_vector_norm", "var_mean", "var", "std", "argmax",
              "any", "all", "_foreach_norm")
SPAN_PREFIX = "bench:"  # the benchmark's own record_function spans


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


def op_trees(events: List[dict]) -> Dict[int, Op]:
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


def row_op(op: Op) -> Op:
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


def busy_us(intervals: List[tuple]) -> float:
    """The union of the device ops' intervals."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def device_span_us(events: List[dict]) -> float:
    """From the first device op's start to the last one's end; 0 without
    one."""
    device = [(e["ts"], e["ts"] + e.get("dur", 0))
              for e in device_events(events)]
    if not device:
        return 0.0
    return max(stop for _, stop in device) - min(start for start, _ in device)


def device_events(events: List[dict]) -> List[dict]:
    """The kernels, copies and sets of a chrome trace's complete events."""
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_EVENTS]


def attention_flops(op: Op) -> int:
    """softmax(q k^T) v of `spig::pooled_kv_attention`: the two products,
    2 B Nq Nk (C8 + C2)."""
    (q, _), (k, _), (v, _) = op.tensors()[:3]
    return 2 * q[0] * q[1] * k[1] * (q[2] + v[2])


def host_spans(events: List[dict]) -> List[tuple]:
    """(start, end, name) of the benchmark's own spans, outermost first."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(SPAN_PREFIX):])
             for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)
             and e.get("cat") in ("user_annotation", "cpu_op")]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def idle_gaps(events: List[dict], top: int) -> List[list]:
    """The `top` longest stretches with no device operation between the
    first and the last one, each as [what the host was doing, seconds]: the
    benchmark span open at the gap's start and the innermost CPU op running
    then (main thread of that span)."""
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                    for e in device_events(events))
    gaps, end = [], None
    for start, stop in device:
        if end is not None and start > end:
            gaps.append((start - end, end))
        end = stop if end is None else max(end, stop)
    spans = host_spans(events)
    cpu = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    out = []
    for length, at in sorted(gaps, reverse=True)[:top]:
        span = next((s[2] for s in spans if s[0] <= at < s[1]), "outside")
        inner = [e for e in cpu if e["ts"] <= at < e["ts"] + e.get("dur", 0)]
        op = (min(inner, key=lambda e: e.get("dur", 0))["name"]
              if inner else "python")
        out.append([f"{span}/{op}"[:120], length * 1e-6])
    return out


def top_device_ops(events: List[dict], top: int) -> List[list]:
    """The `top` device operations by summed time: [name, seconds]."""
    total = collections.Counter()
    for e in device_events(events):
        total[e["name"][:120]] += e.get("dur", 0)
    return [[name, us * 1e-6] for name, us in total.most_common(top)]
