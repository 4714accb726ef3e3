"""Profiling hook, counterpart of the JAX package's utils/profiling.py.

`trace(log_dir)` wraps a code region in a torch.profiler trace of the host
and, where there is one, the card, and writes it as a chrome trace
(`<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

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
