"""Kernel 3: 2x bilinear upsample with align_corners=True (csrc/upsample.cu),
its plain version and its launch count.

Replaces the JAX package's Pallas `upsample_align_corners_pallas` forward
(ops/pallas/resize.py). Tensors are NCHW-logical; the kernel reads
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


def upsample_2x_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) as the JAX matrix form A_h x A_w^T, in
    x's dtype (bf16 rounds between the H and the W pass, as JAX does)."""
    from semantic_pyramid_for_image_generation_torch.ops.resize import (
        _bilinear_matrix_align_corners,
    )

    _, _, h, w = x.shape
    a_h = torch.tensor(_bilinear_matrix_align_corners(h, 2 * h),
                       dtype=x.dtype, device=x.device)
    a_w = torch.tensor(_bilinear_matrix_align_corners(w, 2 * w),
                       dtype=x.dtype, device=x.device)
    return torch.matmul(torch.matmul(a_h, x), a_w.T)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.UpsamplingBilinear2d(scale_factor=2): the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"upsample_2x: need (B, C, H, W), got {tuple(x.shape)}")
    if not _launch.runs_kernel("upsample_2x", x):
        return upsample_2x_plain(x)
    code = _launch.dtype_code("upsample_2x", x)
    _launch.check_channels_last("upsample_2x", x)
    b, c, h, w = x.shape
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    check(library().spig_upsample_2x(
        x.data_ptr(), out.data_ptr(), b, h, w, c, code,
        _launch.stream(x.device)), "upsample_2x")
    launches += 1
    return out
