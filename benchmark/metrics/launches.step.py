"""Device operations (kernels, copies, sets) per step launched under the
program's `sp:step` span and the spans inside it, in the sub-window traced
with shapes: what a CUDA graph or fused kernels would cut
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.per_step(run, "launches", spans.in_step)
