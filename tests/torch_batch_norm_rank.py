"""One rank of the fused batch norm over a global batch
(tests/test_torch_batch_norm.py):

    python tests/torch_batch_norm_rank.py INPUTS.pt OUT_DIR FAULT  # RANK, ...

The rank joins a gloo group, takes its contiguous share of the rows of the
inputs' bf16 x, tables and probe, runs `layers._fused_norm` in training mode
(the batch statistics all-reduced over the ranks, and in the backward the
statistics' gradients), backpropagates its share of the probed sum, and
writes its output, the gradients of its x and tables and the running
statistics to OUT_DIR/rank<r>.pt. FAULT "bn_local" plants statistics taken
over the rank's rows alone (the all-reduce made the identity); "sound" runs
the port as it is. Imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from semantic_pyramid_for_image_generation_torch.models import (  # noqa: E402
    layers,
)


def main(inputs: str, out: str, fault: str) -> None:
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    data = torch.load(inputs, weights_only=False)
    rows = data["x"].shape[0] // world
    share = slice(rank * rows, (rank + 1) * rows)
    x = data["x"][share].contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    per_row = data["gain"].shape[0] > 1
    gain, bias = (data[k][share] if per_row else data[k]
                  for k in ("gain", "bias"))
    gain, bias = (t.clone().requires_grad_(True) for t in (gain, bias))
    bn = torch.nn.BatchNorm2d(x.shape[1], affine=False, momentum=0.1)
    if fault == "bn_local":
        layers.all_reduce_sum = lambda t: t
    y = layers._fused_norm(x, bn, gain, bias, data["slope"])
    (y.float() * data["probe"][share]).sum().backward()
    torch.save({"y": y.detach(), "x_grad": x.grad, "gain_grad": gain.grad,
                "bias_grad": bias.grad, "running_mean": bn.running_mean,
                "running_var": bn.running_var},
               Path(out) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
