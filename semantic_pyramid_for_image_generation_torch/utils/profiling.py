"""Profiling hooks, counterpart of the JAX package's utils/profiling.py.

`trace(log_dir)` wraps a code region in a torch.profiler trace of the host
and, where there is one, the card, and writes it as a chrome trace
(`<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing).
`StepTimer` times repeated blocks on the host clock, the first few left out.
`iteration_ms` times a call on the card with CUDA events (the host clock on
the CPU), and `launches_of` counts the port kernels one call launches: the
scripts' microbenchmarks use both.

`span(name)` names a phase of the train loop or the train step in a
profiler's trace, as the range `sp:<name>` (a `user_annotation` on the
host's timeline, on the same clock as the device operations it launches).
It is gated on `torch.autograd.profiler._is_profiler_enabled`: with no
profiler recording it enters no `record_function` and costs one flag check.
The spans: `sp:loop.rng`, `sp:loop.to_device` and `sp:loop.fetch_metrics`
around the loop's work between steps; `sp:step` around a whole step, with
its phases inside it (`sp:step.inputs`, `sp:step.pyramid.forward`,
`sp:step.{d,g}_phase.{forward,backward,adam}` of the GAN step,
`sp:step.{forward,backward,adam}` of the fine-tune step; BigGAN-deep's
step runs each D update under the GAN step's `sp:step.d_phase.*` names and
its EMA under `sp:step.ema`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List

import torch

SPAN_PREFIX = "sp:"  # unlike the benchmark's `bench:` and aten / spig ops
_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A `with` block named `sp:<name>` in the trace of a running profiler;
    with none running, one shared no-op context. The flag is read from its
    module at each call, as the profiler sets it there when it starts and
    stops."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Host wall-clock seconds of each `with timer:` block, the first
    `warmup` blocks left out; `times` holds the rest and `mean` their mean
    (0 before any).

    On the card a launch returns before its work is done: call
    `torch.cuda.synchronize()` inside the block (as a JAX caller blocks until
    ready), or the timer measures launches, not work."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0
        self._t0 = 0.0

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def iteration_ms(fn: Callable[[], object], device: torch.device, iters: int,
                 warmup: int = 2) -> float:
    """ms per call of `fn` over `iters` calls after `warmup` untimed ones.
    On a CUDA device: CUDA events around the calls, recorded after a
    synchronize, so the time is the card's and not the host's enqueue. On
    the CPU: the host clock (not a device time)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launches_of(fn: Callable[[], object]) -> Dict[str, int]:
    """The port kernels' launches during one call of `fn`: the counters'
    change (ops/cuda/__init__.py), which are not reset. 0 each on the CPU,
    where the plain versions run."""
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

    before = kernels.launch_counts()
    fn()
    after = kernels.launch_counts()
    return {name: after[name] - before[name] for name in after}
