"""Kernel 2: 2x2 / stride-2 max pool (csrc/max_pool.cu), its plain version
and its launch count.

Replaces the JAX package's Pallas `max_pool_2x2_pallas` forward
(ops/pallas/pool.py). Tensors are NCHW-logical; the kernel reads
`torch.channels_last` memory, i.e. NHWC.
"""

from __future__ import annotations

import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda import _launch
from semantic_pyramid_for_image_generation_torch.ops.cuda.build import (
    check,
    library,
)

launches = 0  # kernel launches since the last reset (ops/cuda/__init__.py)


def max_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H/2, W/2): the max over rows, then over columns,
    as the JAX pairwise form does; NaN propagates (torch.maximum)."""
    rows = torch.maximum(x[:, :, 0::2], x[:, :, 1::2])
    return torch.maximum(rows[..., 0::2], rows[..., 1::2])


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(2, 2) for any even H and W: the kernel for a CUDA tensor,
    the plain version for a CPU tensor. Bitwise equal in fp32 and bf16."""
    global launches
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"max_pool_2x2: need (B, C, H, W) with even H and W, "
                         f"got {tuple(x.shape)}")
    if not _launch.runs_kernel("max_pool_2x2", x):
        return max_pool_2x2_plain(x)
    code = _launch.dtype_code("max_pool_2x2", x)
    _launch.check_channels_last("max_pool_2x2", x)
    b, c, h, w = x.shape
    out = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    check(library().spig_max_pool_2x2(
        x.data_ptr(), out.data_ptr(), b, h, w, c, code,
        _launch.stream(x.device)), "max_pool_2x2")
    launches += 1
    return out
