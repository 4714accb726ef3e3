"""Pooling ops with torch semantics on NCHW-logical tensors.

Counterpart of the JAX package's ops/pool.py. The 2x2 / stride-2 max pool
(VGG pools, the attention KV pool, the reconstruction loss pools) runs
Kernel 2 forward and Kernel 4 backward on CUDA. The others the JAX package
computes in XLA, not in Pallas, so they are PyTorch ops here: the
discriminator's 2x2 average pool and global average pool, the loss's 1-D
max pool over fc levels, and the VGG classifier's AdaptiveAvgPool2d((7, 7))
with torch bin edges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.ops.cuda.pool import (
    MaxPool2x2Function,
)


def max_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(2, 2) over even H and W, differentiable with JAX's
    balanced tie rule: Kernels 2 and 4 on CUDA, their plain versions on the
    CPU."""
    return MaxPool2x2Function.apply(
        x.contiguous(memory_format=torch.channels_last))


def avg_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """nn.AvgPool2d(2, 2) over even H and W."""
    return F.avg_pool2d(x, 2)


def max_pool_1d(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool1d(2) over the last axis; an odd trailing element is dropped.
    The pairwise torch.maximum splits a tie's gradient in halves, as JAX's
    maximum does."""
    even = 2 * (x.shape[-1] // 2)
    return torch.maximum(x[..., 0:even:2], x[..., 1:even:2])


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d((1, 1)) + flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def adaptive_avg_pool_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d((out_h, out_w)): bin i covers
    [floor(i*in/out), ceil((i+1)*in/out))."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
