"""Pooling ops with torch semantics on NCHW-logical tensors.

Counterpart of the JAX package's ops/pool.py for the serving path: the
2x2 / stride-2 max pool (VGG pools and the attention KV pool) runs Kernel 2
on CUDA, and the VGG classifier's AdaptiveAvgPool2d((7, 7)) uses torch bin
edges, which `F.adaptive_avg_pool2d` has (the JAX package computes it in XLA,
not in Pallas).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.ops.cuda.pool import (
    max_pool_2x2,
)


def max_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(2, 2) over even H and W, the only pool of the serving
    path: Kernel 2 on CUDA, its plain version on the CPU."""
    return max_pool_2x2(x.contiguous(memory_format=torch.channels_last))


def adaptive_avg_pool_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d((out_h, out_w)): bin i covers
    [floor(i*in/out), ceil((i+1)*in/out))."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
