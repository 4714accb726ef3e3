"""Kernels 3 and 5: 2x bilinear upsample with align_corners=True, forward
and backward (csrc/upsample.cu), their plain versions, their launch counts
and the autograd Function that joins them.

Kernel 3 replaces the JAX package's Pallas `upsample_align_corners_pallas`
forward and Kernel 5 its backward `_up_bwd` (ops/pallas/resize.py). Tensors
are NCHW-logical; the kernels read `torch.channels_last` memory, i.e. NHWC.

Each kernel is the torch custom op `spig::upsample_2x` /
`spig::upsample_2x_backward`, built as the pool's are (ops/cuda/pool.py):
CUDA implementation the counted launch, CPU implementation the plain
version, a fake implementation with the output's layout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda import _launch
from semantic_pyramid_for_image_generation_torch.ops.cuda._launch import (
    NAMESPACE,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.build import (
    check,
    library,
)

# kernel launches since the last reset (ops/cuda/__init__.py)
launches = 0  # Kernel 3, the forward
backward_launches = 0  # Kernel 5, the backward


def _matrices(h: int, w: int, like: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (2h, h) and (2w, w) align-corners matrices in like's dtype."""
    from semantic_pyramid_for_image_generation_torch.ops.resize import (
        _bilinear_matrix_align_corners,
    )

    return tuple(torch.tensor(_bilinear_matrix_align_corners(n, 2 * n),
                              dtype=like.dtype, device=like.device)
                 for n in (h, w))


def upsample_2x_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) as the JAX matrix form A_h x A_w^T, in
    x's dtype (bf16 rounds between the H and the W pass, as JAX does)."""
    a_h, a_w = _matrices(x.shape[2], x.shape[3], x)
    return torch.matmul(torch.matmul(a_h, x), a_w.T)


@torch.library.custom_op(f"{NAMESPACE}::upsample_2x", mutates_args=(),
                         device_types="cuda")
def _upsample_2x_op(x: torch.Tensor) -> torch.Tensor:
    """Kernel 3 on a channels_last CUDA tensor."""
    global launches
    code = _launch.dtype_code("upsample_2x", x)
    _launch.check_channels_last("upsample_2x", x)
    b, c, h, w = x.shape
    out = _launch.channels_last_like(x, (b, c, 2 * h, 2 * w))
    check(library().spig_upsample_2x(
        x.data_ptr(), out.data_ptr(), b, h, w, c, code,
        _launch.stream(x.device)), "upsample_2x")
    launches += 1
    return out


_upsample_2x_op.register_kernel("cpu")(upsample_2x_plain)


@_upsample_2x_op.register_fake
def _(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    if x.device.type == "cpu":  # the plain version's matmul: contiguous
        return x.new_empty((b, c, 2 * h, 2 * w))
    return _launch.channels_last_like(x, (b, c, 2 * h, 2 * w))


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.UpsamplingBilinear2d(scale_factor=2): the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.dim() != 4:
        raise ValueError(f"upsample_2x: need (B, C, H, W), got {tuple(x.shape)}")
    _launch.check_devices("upsample_2x", x)
    return _upsample_2x_op(x)


def upsample_2x_backward_plain(g: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) -> (B, C, H, W): A_h^T g A_w, the transposed matrix
    form in g's dtype, H pass first as `_up_bwd` runs it."""
    a_h, a_w = _matrices(g.shape[2] // 2, g.shape[3] // 2, g)
    return torch.matmul(torch.matmul(a_h.T, g), a_w)


@torch.library.custom_op(f"{NAMESPACE}::upsample_2x_backward",
                         mutates_args=(), device_types="cuda")
def _upsample_2x_backward_op(g: torch.Tensor) -> torch.Tensor:
    """Kernel 5 on a CUDA gradient of any layout."""
    global backward_launches
    code = _launch.dtype_code("upsample_2x_backward", g)
    g = g.contiguous(memory_format=torch.channels_last)
    b, c, h, w = g.shape[0], g.shape[1], g.shape[2] // 2, g.shape[3] // 2
    gx = _launch.channels_last_like(g, (b, c, h, w))
    check(library().spig_upsample_2x_backward(
        g.data_ptr(), gx.data_ptr(), b, h, w, c, code,
        _launch.stream(g.device)), "upsample_2x_backward")
    backward_launches += 1
    return gx


_upsample_2x_backward_op.register_kernel("cpu")(upsample_2x_backward_plain)


@_upsample_2x_backward_op.register_fake
def _(g: torch.Tensor) -> torch.Tensor:
    b, c, h, w = g.shape[0], g.shape[1], g.shape[2] // 2, g.shape[3] // 2
    if g.device.type == "cpu":  # the plain version's matmul: contiguous
        return g.new_empty((b, c, h, w))
    return _launch.channels_last_like(g, (b, c, h, w))


def upsample_2x_backward(g: torch.Tensor) -> torch.Tensor:
    """The input gradient of `upsample_2x` for the output gradient g (even H
    and W): the kernel for a CUDA tensor, the plain version for a CPU tensor.
    g may come in any layout; it is made channels_last before the launch."""
    if g.dim() != 4 or g.shape[2] % 2 or g.shape[3] % 2:
        raise ValueError(f"upsample_2x_backward: need (B, C, 2H, 2W), got "
                         f"{tuple(g.shape)}")
    _launch.check_devices("upsample_2x_backward", g)
    return _upsample_2x_backward_op(g)


class Upsample2xFunction(torch.autograd.Function):
    """Kernel 3 forward, Kernel 5 backward (plain versions on the CPU), as
    `upsample_align_corners_pallas`'s custom VJP pairs them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return upsample_2x(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return upsample_2x_backward(g)
