"""Resampling ops with torch semantics.

Counterpart of the JAX package's ops/resize.py for the serving path: the
generator's 2x align-corners bilinear upsample (Kernel 3 on CUDA), the
align-corners interpolation matrix its plain version applies, and the
host-side nearest resize of the mask pipeline.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    upsample_2x,
)


@functools.lru_cache(maxsize=None)
def _bilinear_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic linear-interpolation matrix, align_corners=True:
    source coordinate of output i is i * (in-1)/(out-1)."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        a[:, 0] = 1.0
        return a
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for i in range(out_size):
        x = i * scale
        x0 = int(np.floor(x))
        x1 = min(x0 + 1, in_size - 1)
        w1 = x - x0
        a[i, x0] += 1.0 - w1
        a[i, x1] += w1
    a.setflags(write=False)  # cached and shared by every caller
    return a


def upsample_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """nn.UpsamplingBilinear2d(scale_factor=2) on a (B, C, H, W) tensor, the
    generator's only resize: Kernel 3 on CUDA, its plain version on the CPU."""
    return upsample_2x(x.contiguous(memory_format=torch.channels_last))


def interpolate_nearest_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch 'nearest' resize of a host (H, W) array (mask pipeline)."""
    h, w = x.shape
    rows = np.minimum(np.arange(out_h) * h // out_h, h - 1)
    cols = np.minimum(np.arange(out_w) * w // out_w, w - 1)
    return x[rows][:, cols]
