"""Kernels 2 and 4: 2x2 / stride-2 max pool forward and backward
(csrc/max_pool.cu), their plain versions, their launch counts and the
autograd Function that joins them.

Kernel 2 replaces the JAX package's Pallas `max_pool_2x2_pallas` forward and
Kernel 4 its backward `_mp_vjp_bwd` (ops/pallas/pool.py). Tensors are
NCHW-logical; the kernels read `torch.channels_last` memory, i.e. NHWC.

Each kernel is the torch custom op `spig::max_pool_2x2` /
`spig::max_pool_2x2_backward`: its CUDA implementation launches the kernel
(and counts the launch), its CPU implementation is the plain version, and
its fake implementation gives the output's shape and layout, so a program
traced by `torch.export` (serving/export.py) calls the kernel as one node.
"""

from __future__ import annotations

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
launches = 0  # Kernel 2, the forward
backward_launches = 0  # Kernel 4, the backward


def _check_shape(what: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"{what}: need (B, C, H, W) with even H and W, "
                         f"got {tuple(x.shape)}")


def max_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H/2, W/2): the max over rows, then over columns,
    as the JAX pairwise form does; NaN propagates (torch.maximum)."""
    rows = torch.maximum(x[:, :, 0::2], x[:, :, 1::2])
    return torch.maximum(rows[..., 0::2], rows[..., 1::2])


@torch.library.custom_op(f"{NAMESPACE}::max_pool_2x2", mutates_args=(),
                         device_types="cuda")
def _max_pool_2x2_op(x: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on a channels_last CUDA tensor."""
    global launches
    code = _launch.dtype_code("max_pool_2x2", x)
    _launch.check_channels_last("max_pool_2x2", x)
    b, c, h, w = x.shape
    out = _launch.channels_last_like(x, (b, c, h // 2, w // 2))
    check(library().spig_max_pool_2x2(
        x.data_ptr(), out.data_ptr(), b, h, w, c, code,
        _launch.stream(x.device)), "max_pool_2x2")
    launches += 1
    return out


_max_pool_2x2_op.register_kernel("cpu")(max_pool_2x2_plain)


@_max_pool_2x2_op.register_fake
def _(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":  # the plain version's layout
        return max_pool_2x2_plain(x)
    b, c, h, w = x.shape
    return _launch.channels_last_like(x, (b, c, h // 2, w // 2))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(2, 2) for any even H and W: the kernel for a CUDA tensor,
    the plain version for a CPU tensor. Bitwise equal in fp32 and bf16."""
    _check_shape("max_pool_2x2", x)
    _launch.check_devices("max_pool_2x2", x)
    return _max_pool_2x2_op(x)


def _balanced(eq_self: torch.Tensor, eq_other: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """JAX's maximum transpose rule: all of g where only self attained the
    max, g/2 on a tie, 0 where self did not."""
    return torch.where(eq_self, torch.where(eq_other, g * 0.5, g),
                       g.new_zeros(()))


def max_pool_2x2_backward_plain(x: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """The gradient of `max_pool_2x2_plain` at x for the output gradient g,
    by JAX's balanced-eq rule: recompute the forward, route g between the
    two row maxima (column level), then inside each column (row level).
    Computed in fp32 (float64 stays float64), returned in x's dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    xw, gw = x.to(wide), g.to(wide)
    x00, x01 = xw[:, :, 0::2, 0::2], xw[:, :, 0::2, 1::2]
    x10, x11 = xw[:, :, 1::2, 0::2], xw[:, :, 1::2, 1::2]
    m0, m1 = torch.maximum(x00, x10), torch.maximum(x01, x11)
    out = torch.maximum(m0, m1)
    ge = _balanced(m0 == out, m1 == out, gw)
    go = _balanced(m1 == out, m0 == out, gw)
    gx = torch.empty_like(xw)
    gx[:, :, 0::2, 0::2] = _balanced(x00 == m0, x10 == m0, ge)
    gx[:, :, 1::2, 0::2] = _balanced(x10 == m0, x00 == m0, ge)
    gx[:, :, 0::2, 1::2] = _balanced(x01 == m1, x11 == m1, go)
    gx[:, :, 1::2, 1::2] = _balanced(x11 == m1, x01 == m1, go)
    return gx.to(x.dtype)


@torch.library.custom_op(f"{NAMESPACE}::max_pool_2x2_backward",
                         mutates_args=(), device_types="cuda")
def _max_pool_2x2_backward_op(x: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Kernel 4 on a channels_last x and a g of any layout, on CUDA."""
    global backward_launches
    code = _launch.dtype_code("max_pool_2x2_backward", x, g)
    _launch.check_channels_last("max_pool_2x2_backward", x)
    g = g.contiguous(memory_format=torch.channels_last)
    b, c, h, w = x.shape
    gx = _launch.channels_last_like(x, (b, c, h, w))
    check(library().spig_max_pool_2x2_backward(
        x.data_ptr(), g.data_ptr(), gx.data_ptr(), b, h, w, c, code,
        _launch.stream(x.device)), "max_pool_2x2_backward")
    backward_launches += 1
    return gx


_max_pool_2x2_backward_op.register_kernel("cpu")(max_pool_2x2_backward_plain)


@_max_pool_2x2_backward_op.register_fake
def _(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":  # the plain version's gx is laid out as x
        return torch.empty_like(x)
    return _launch.channels_last_like(x, tuple(x.shape))


def max_pool_2x2_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(x (B, C, H, W), g (B, C, H/2, W/2)) -> gx (B, C, H, W): the kernel for
    CUDA tensors, the plain version for CPU tensors. Bitwise equal in fp32
    and bf16. g may come in any layout (autograd hands over what the next
    op produced); it is made channels_last before the launch."""
    _check_shape("max_pool_2x2_backward", x)
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, c, h // 2, w // 2):
        raise ValueError(f"max_pool_2x2_backward: g has shape "
                         f"{tuple(g.shape)}, want {(b, c, h // 2, w // 2)}")
    _launch.check_devices("max_pool_2x2_backward", x, g)
    return _max_pool_2x2_backward_op(x, g)


class MaxPool2x2Function(torch.autograd.Function):
    """Kernel 2 forward, Kernel 4 backward (plain versions on the CPU), as
    `max_pool_2x2_pallas`'s custom VJP pairs them. Saves x, not indices."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return max_pool_2x2(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return max_pool_2x2_backward(x, g)
