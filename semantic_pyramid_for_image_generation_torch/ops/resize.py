"""Resampling ops with torch semantics.

Counterpart of the JAX package's ops/resize.py: the generator's 2x
align-corners bilinear upsample (Kernel 3 forward and Kernel 5 backward on
CUDA), the align-corners interpolation matrix their plain versions apply,
the align-corners resize to any size, the FID's half-pixel resize and the
nearest resize, on tensors and on the mask pipeline's host arrays.

The generator's upsample takes (B, C, H, W) tensors, as the modules that
call it do; every other resize here takes NHWC, as the JAX package's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    Upsample2xFunction,
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
    generator's only resize, differentiable: Kernels 3 and 5 on CUDA, their
    plain versions on the CPU."""
    return Upsample2xFunction.apply(
        x.contiguous(memory_format=torch.channels_last))


def resize_bilinear_half_pixel(x: torch.Tensor, out_h: int,
                               out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (torch align_corners=False) and
    no antialiasing, of an NHWC tensor: the FID input resize to 299. Not a
    Pallas kernel in the JAX package (jax.image.resize there), so the library
    call it is."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def _apply_separable(x: torch.Tensor, a_h: np.ndarray,
                     a_w: np.ndarray) -> torch.Tensor:
    """The per-axis (out, in) matrices applied to an NHWC tensor, H first,
    in x's dtype (the JAX package's matrix form)."""
    a_h, a_w = (torch.tensor(a, dtype=x.dtype, device=x.device)
                for a in (a_h, a_w))
    x = torch.einsum("oh,bhwc->bowc", a_h, x)
    return torch.einsum("ow,bhwc->bhoc", a_w, x)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NHWC tensor to any
    (out_h, out_w). Plain PyTorch: in the JAX package it is an einsum pair,
    not a Pallas kernel."""
    _, h, w, _ = x.shape
    return _apply_separable(x, _bilinear_matrix_align_corners(h, out_h),
                            _bilinear_matrix_align_corners(w, out_w))


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch 'nearest' source index of each output: floor(i * in / out)."""
    return np.minimum(np.arange(out_size) * in_size // out_size, in_size - 1)


def interpolate_nearest(x: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """torch `F.interpolate(mode='nearest')` of an NHWC tensor."""
    _, h, w, _ = x.shape
    rows, cols = (torch.from_numpy(_nearest_index(n, m)).to(x.device)
                  for n, m in ((h, out_h), (w, out_w)))
    return x.index_select(1, rows).index_select(2, cols)


def interpolate_nearest_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch 'nearest' resize of a host (H, W) array (mask pipeline)."""
    h, w = x.shape
    return x[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]
