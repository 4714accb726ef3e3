"""The share of the training cells' device-only sub-window (the traffic
mix's first `subwindow_units` of steps, traced for CUDA activity alone, no
host ops, no shapes), from its first device operation to its last, in which
no kernel and no copy ran."""

from benchmark.harness import idle_pct


def read(run):
    return idle_pct(run)
