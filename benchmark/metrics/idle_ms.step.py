"""Idle device time per step put down to the program's `sp:step` span and
the spans inside it, in the sub-window traced with shapes: where the host
falls behind inside the step. Read under the profiler's host cost, so it
locates the gaps and does not measure the untraced idle share
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "idle_us", spans.in_step)
