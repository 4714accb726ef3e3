"""The program's phase spans in a sub-window's trace: the `sp:` ranges that
the port's `utils/profiling.py::span` opens at the boundaries of its train
loop and train step, and the device time, launches and idle gaps put down
to each.

  * A device operation (kernel, copy or set) belongs to the innermost `sp:`
    span, on any thread, whose interval holds the start of the CPU op that
    launched it, found through its `External id` as `trace.py` joins them.
    The rule goes by time, not by nesting: on CUDA the autograd engine
    launches the backward from its own thread while the main thread waits
    inside the `.backward` span.
  * An operation's device time is the time it adds to the busy time: its
    duration less what operations that started before it already cover.
    On one stream that is its duration; a pageable host-to-device copy's
    interval starts while the kernels before it still run, and its
    duration would count that stretch twice.
  * An idle gap between device operations, found as `trace.idle_gaps` finds
    them, belongs to the innermost `sp:` span open at the gap's start; with
    none open, to no span.

So the device times of all spans sum to at most the busy time.

A span's host range is a `user_annotation`; its `gpu_user_annotation` twin
on the device's timeline is not read. The readers divide by the
sub-window's units: a value per step.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import trace as tr

PREFIX = "sp:"  # the program's spans; apart from `bench:`, aten and spig


@dataclasses.dataclass
class Split:
    """Per span name (without the prefix): the summed device time and the
    count of the device operations launched under it, and the idle time
    put down to it, in microseconds over the whole sub-window."""
    device_us: Dict[str, float]
    launches: Dict[str, int]
    idle_us: Dict[str, float]


def host_spans(events: List[dict]) -> List[Tuple[float, float, str]]:
    """(start, end, name without the prefix) of the program's spans."""
    return [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(PREFIX):])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)]


def innermost(spans: List[Tuple[float, float, str]], at: float
              ) -> Optional[str]:
    """The name of the shortest span open at `at`; None with none open."""
    best = None
    for start, end, name in spans:
        if start <= at < end and (best is None
                                  or end - start < best[1] - best[0]):
            best = (start, end, name)
    return None if best is None else best[2]


def split(events: List[dict]) -> Split:
    """Each span's device time, launches and idle time (module docstring)."""
    spans = host_spans(events)
    ops = tr.op_trees(events)
    device_us = collections.defaultdict(float)
    launches = collections.Counter()
    idle_us = collections.defaultdict(float)
    end = -math.inf  # of the device operations so far
    for e in sorted(tr.device_events(events),
                    key=lambda e: (e["ts"], e["ts"] + e.get("dur", 0))):
        start, stop = e["ts"], e["ts"] + e.get("dur", 0)
        if -math.inf < end < start:
            name = innermost(spans, end)
            if name is not None:
                idle_us[name] += start - end
        own = max(0.0, stop - max(start, end))
        end = max(end, stop)
        launcher = ops.get(e.get("args", {}).get("External id"))
        name = None if launcher is None else innermost(spans, launcher.start)
        if name is not None:
            device_us[name] += own
            launches[name] += 1
    return Split(dict(device_us), dict(launches), dict(idle_us))


def in_loop(name: str) -> bool:
    return name.startswith("loop.")


def in_step(name: str) -> bool:
    return name == "step" or name.startswith("step.")


def per_step(run, what: str, match: Callable[[str], bool]
             ) -> Optional[float]:
    """The sum of `what` ("device_us", "launches" or "idle_us") over the
    spans `match` picks in the sub-window traced with shapes, per step;
    None off the card or when that trace holds no span of the program."""
    sub = run.shapes
    if not run.on_card or sub is None or not host_spans(sub["events"]):
        return None
    values = getattr(split(sub["events"]), what)
    return sum(v for name, v in values.items() if match(name)) / sub["units"]


def ms_per_step(run, what: str, match: Callable[[str], bool]
                ) -> Optional[float]:
    us = per_step(run, what, match)
    return None if us is None else us * 1e-3
