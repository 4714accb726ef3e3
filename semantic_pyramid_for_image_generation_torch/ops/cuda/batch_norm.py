"""Kernels 6-9: the generators' training-mode batch norms on bf16
activations, fused with the activation that follows them
(csrc/batch_norm.cu), their plain versions, their launch counts and the
autograd Functions that join them.

They replace no Pallas kernel: the JAX package leaves its batch norms to
XLA, which fuses them; here they take the place of a dozen eager float32
passes. Tensors are NCHW-logical; the kernels read `torch.channels_last`
memory, i.e. NHWC. A norm's per-element work is

    y = act(x * scale[s, c] + shift[s, c]),  act(p) = p if p > 0 else slope p

with float32 tables of one row per sample (s = b: the conditional norms) or
one row for the batch (s = 0: `BatchNorm`'s affine), and `slope` 0 for
ReLU, 0.2 for LeakyReLU(0.2), 1 for no activation. The batch statistics
behind scale and shift are small torch ops on (C,) vectors
(models/layers.py); the four kernels are

  * `spig::batch_norm_stats_(sums, x)`: sums = [sum x, sum x^2] per
    channel, (2, C) float32, written into its first argument;
  * `spig::batch_norm_apply(x, scale, shift, slope)`: y in x's dtype;
  * `spig::batch_norm_backward_sums_(sums, dy, x, scale, shift, slope)`:
    sums = [sum g', sum g' x] per (table row, channel), (2, S, C), where
    g' = dy * act'(x * scale + shift), the slope where that is <= 0;
  * `spig::batch_norm_backward_dx(dy, x, scale, shift, k, slope)`:
    dx = g' scale + k[0] + k[1] x, in x's dtype.

Each op's tensor arguments are what its kernel reads, and its output (or
its first, written argument) what it writes. On the CPU each runs its
plain version and counts nothing. The kernels take bf16; the plain
versions any floating dtype (the gradchecks run them in float64).
"""

from __future__ import annotations

from typing import Optional

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
stats_launches = 0  # Kernel 6
apply_launches = 0  # Kernel 7
backward_sums_launches = 0  # Kernel 8
backward_dx_launches = 0  # Kernel 9


def _table(t: torch.Tensor) -> torch.Tensor:
    """(S, C) -> (S, C, 1, 1), broadcast over (B, C, H, W) for S in 1, B."""
    return t[:, :, None, None]


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _pre(x: torch.Tensor, scale: torch.Tensor,
         shift: torch.Tensor) -> torch.Tensor:
    return _wide(x) * _table(scale) + _table(shift)


def batch_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (2, C): the sum and the sum of squares over (B, H, W),
    in float32 (float64 stays float64)."""
    xw = _wide(x)
    return torch.stack([xw.sum(dim=(0, 2, 3)), (xw * xw).sum(dim=(0, 2, 3))])


def batch_norm_apply_plain(x: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, slope: float) -> torch.Tensor:
    pre = _pre(x, scale, shift)
    return torch.where(pre > 0, pre, pre * slope).to(x.dtype)


def _g(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
       shift: torch.Tensor, slope: float) -> torch.Tensor:
    gw = _wide(dy)
    return torch.where(_pre(x, scale, shift) > 0, gw, gw * slope)


def batch_norm_backward_sums_plain(dy: torch.Tensor, x: torch.Tensor,
                                   scale: torch.Tensor, shift: torch.Tensor,
                                   slope: float) -> torch.Tensor:
    """(2, S, C): the sums of g' and of g' x over each table row's rows
    (S = B: over (H, W) per sample; S = 1: over (B, H, W))."""
    g = _g(dy, x, scale, shift, slope)
    dims = (2, 3) if scale.shape[0] > 1 else (0, 2, 3)
    sums = [g.sum(dim=dims), (g * _wide(x)).sum(dim=dims)]
    return torch.stack([s.reshape(scale.shape) for s in sums])


def batch_norm_backward_dx_plain(dy: torch.Tensor, x: torch.Tensor,
                                 scale: torch.Tensor, shift: torch.Tensor,
                                 k: torch.Tensor, slope: float
                                 ) -> torch.Tensor:
    g = _g(dy, x, scale, shift, slope)
    return (g * _table(scale) + _table(k[:1]) + _table(k[1:]) * _wide(x)
            ).to(x.dtype)


# ------------------------------------------------------------ the ops --


def _geometry(what: str, x: torch.Tensor,
              scale: Optional[torch.Tensor] = None):
    """(rows per table row, table rows, channels) of a launch; checks the
    kernels' dtype, layout and tables (none: one segment)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16 x, got {x.dtype}")
    _launch.check_channels_last(what, x)
    b, c, h, w = x.shape
    if scale is None:
        return b * h * w, 1, c
    segments = scale.shape[0]
    if (scale.dtype != torch.float32 or not scale.is_contiguous()
            or scale.shape != (segments, c) or segments not in (1, b)):
        raise ValueError(f"{what}: tables must be contiguous float32 (1, C) "
                         f"or (B, C), got {tuple(scale.shape)} {scale.dtype}")
    return b * h * w // segments, segments, c


def _workspace(rows: int, segments: int, c: int,
               device: torch.device) -> Optional[torch.Tensor]:
    n = library().spig_batch_norm_workspace(rows, segments, c)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@torch.library.custom_op(f"{NAMESPACE}::batch_norm_stats_",
                         mutates_args=("sums",), device_types="cuda")
def _stats_op(sums: torch.Tensor, x: torch.Tensor) -> None:
    """Kernel 6 into a (2, C) float32 `sums` on the card."""
    global stats_launches
    rows, _, c = _geometry("batch_norm_stats_", x)
    ws = _workspace(rows, 1, c, x.device)
    check(library().spig_batch_norm_sums(
        x.data_ptr(), None, None, None, 0.0, _ptr(ws), sums.data_ptr(),
        rows, 1, c, _launch.stream(x.device)), "batch_norm_stats_")
    stats_launches += 1


@_stats_op.register_kernel("cpu")
def _(sums: torch.Tensor, x: torch.Tensor) -> None:
    sums.copy_(batch_norm_stats_plain(x))


@_stats_op.register_fake
def _(sums: torch.Tensor, x: torch.Tensor) -> None:
    return None


def batch_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (2, C) float32 [sum x, sum x^2] over (B, H, W): Kernel
    6 for a CUDA tensor, the plain version for a CPU tensor."""
    _launch.check_devices("batch_norm_stats", x)
    if x.dim() != 4:
        raise ValueError(f"batch_norm_stats: need (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    sums = torch.empty((2, x.shape[1]), device=x.device,
                       dtype=torch.promote_types(x.dtype, torch.float32))
    _stats_op(sums, x)
    return sums


@torch.library.custom_op(f"{NAMESPACE}::batch_norm_apply", mutates_args=(),
                         device_types="cuda")
def _apply_op(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              slope: float) -> torch.Tensor:
    """Kernel 7 on a channels_last bf16 CUDA tensor."""
    global apply_launches
    rows, segments, c = _geometry("batch_norm_apply", x, scale)
    y = _launch.channels_last_like(x, tuple(x.shape))
    check(library().spig_batch_norm_apply(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), slope, y.data_ptr(),
        rows, segments, c, _launch.stream(x.device)), "batch_norm_apply")
    apply_launches += 1
    return y


_apply_op.register_kernel("cpu")(batch_norm_apply_plain)


@_apply_op.register_fake
def _(x, scale, shift, slope):
    if x.device.type == "cpu":
        return torch.empty_like(x)
    return _launch.channels_last_like(x, tuple(x.shape))


@torch.library.custom_op(f"{NAMESPACE}::batch_norm_backward_sums_",
                         mutates_args=("sums",), device_types="cuda")
def _backward_sums_op(sums: torch.Tensor, dy: torch.Tensor, x: torch.Tensor,
                      scale: torch.Tensor, shift: torch.Tensor,
                      slope: float) -> None:
    """Kernel 8 into a (2, S, C) float32 `sums` on the card."""
    global backward_sums_launches
    rows, segments, c = _geometry("batch_norm_backward_sums_", x, scale)
    ws = _workspace(rows, segments, c, x.device)
    check(library().spig_batch_norm_sums(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        slope, _ptr(ws), sums.data_ptr(), rows, segments, c,
        _launch.stream(x.device)), "batch_norm_backward_sums_")
    backward_sums_launches += 1


@_backward_sums_op.register_kernel("cpu")
def _(sums, dy, x, scale, shift, slope) -> None:
    sums.copy_(batch_norm_backward_sums_plain(dy, x, scale, shift, slope))


@_backward_sums_op.register_fake
def _(sums, dy, x, scale, shift, slope) -> None:
    return None


@torch.library.custom_op(f"{NAMESPACE}::batch_norm_backward_dx",
                         mutates_args=(), device_types="cuda")
def _backward_dx_op(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, k: torch.Tensor,
                    slope: float) -> torch.Tensor:
    """Kernel 9 on channels_last bf16 CUDA tensors."""
    global backward_dx_launches
    rows, segments, c = _geometry("batch_norm_backward_dx", x, scale)
    dx = _launch.channels_last_like(x, tuple(x.shape))
    check(library().spig_batch_norm_backward_dx(
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        k.data_ptr(), slope, dx.data_ptr(), rows, segments, c,
        _launch.stream(x.device)), "batch_norm_backward_dx")
    backward_dx_launches += 1
    return dx


_backward_dx_op.register_kernel("cpu")(batch_norm_backward_dx_plain)


@_backward_dx_op.register_fake
def _(dy, x, scale, shift, k, slope):
    if x.device.type == "cpu":
        return torch.empty_like(x)
    return _launch.channels_last_like(x, tuple(x.shape))


def _check_tables(what: str, x: torch.Tensor, *tables: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: need (B, C, H, W), got {tuple(x.shape)}")
    _launch.check_devices(what, x, *tables)


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, slope: float) -> torch.Tensor:
    """act(x * scale + shift) per (table row, channel): Kernel 7 for CUDA
    tensors, the plain version for CPU tensors."""
    _check_tables("batch_norm_apply", x, scale, shift)
    return _apply_op(x, scale, shift, float(slope))


def batch_norm_backward_sums(dy: torch.Tensor, x: torch.Tensor,
                             scale: torch.Tensor, shift: torch.Tensor,
                             slope: float) -> torch.Tensor:
    """(2, S, C) [sum g', sum g' x]: Kernel 8 for CUDA tensors, the plain
    version for CPU tensors. dy may come in any layout (autograd hands over
    what the next op produced); it is made channels_last first."""
    _check_tables("batch_norm_backward_sums", x, dy, scale, shift)
    dy = dy.contiguous(memory_format=torch.channels_last)
    sums = torch.empty((2, *scale.shape), dtype=scale.dtype,
                       device=scale.device)
    _backward_sums_op(sums, dy, x, scale, shift, float(slope))
    return sums


def batch_norm_backward_dx(dy: torch.Tensor, x: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           k: torch.Tensor, slope: float) -> torch.Tensor:
    """g' scale + k[0] + k[1] x: Kernel 9 for CUDA tensors, the plain
    version for CPU tensors (dy made channels_last first)."""
    _check_tables("batch_norm_backward_dx", x, dy, scale, shift, k)
    dy = dy.contiguous(memory_format=torch.channels_last)
    return _backward_dx_op(dy, x, scale, shift, k.contiguous(), float(slope))


# ------------------------------------------------------- the Functions --


class BatchNormLink:
    """What the apply's backward hands to the statistics' backward: the
    apply's output gradient and saved tensors. x's whole gradient, through
    the apply and through the statistics, is then one pass of Kernel 9,
    which the statistics' backward runs: autograd reaches it after the
    apply's backward and the small ops between them."""

    __slots__ = ("saved",)

    def __init__(self):
        self.saved = None


class BatchNormStatsFunction(torch.autograd.Function):
    """sums = [sum x, sum x^2] per channel (Kernel 6). Its backward takes
    the sums' gradient k (as (d sum x, 2 d sum x^2)) and runs Kernel 9 with
    what the apply's backward left in `link`: dx = g' scale + k[0] + k[1] x."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, link: BatchNormLink) -> torch.Tensor:
        ctx.link = link
        return batch_norm_stats(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_sums: torch.Tensor):
        saved, ctx.link.saved = ctx.link.saved, None
        if saved is None:
            raise RuntimeError("batch norm statistics: their gradient is "
                               "taken with the apply's, which did not run")
        dy, x, scale, shift, slope = saved
        k = torch.stack([d_sums[0], 2.0 * d_sums[1]])
        return batch_norm_backward_dx(dy, x, scale, shift, k, slope), None


class BatchNormApplyFunction(torch.autograd.Function):
    """y = act(x * scale + shift) (Kernel 7), saving x and the tables. Its
    backward gives the tables' gradients from Kernel 8's sums and leaves x's
    to `BatchNormStatsFunction` through `link`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, slope: float,
                link: BatchNormLink) -> torch.Tensor:
        ctx.save_for_backward(x, scale, shift)
        ctx.slope, ctx.link = slope, link
        return batch_norm_apply(x, scale, shift, slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, scale, shift = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        sums = batch_norm_backward_sums(dy, x, scale, shift, ctx.slope)
        if ctx.needs_input_grad[0]:
            ctx.link.saved = (dy, x, scale, shift, ctx.slope)
        return None, sums[1], sums[0], None, None
