"""Profiling hooks, counterpart of the JAX package's utils/profiling.py.

`trace(log_dir)` wraps a code region in a torch.profiler trace of the host
and, where there is one, the card, and writes it as a chrome trace
(`<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing).
`StepTimer` times repeated blocks on the host clock, the first few left out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List

import torch


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
