"""What the kernel wrappers share: the device check, dtype codes, the
stream handed to a kernel, and the torch custom-op namespace their kernels
are registered under."""

from __future__ import annotations

import ctypes

import torch

NAMESPACE = "spig"  # torch.ops.spig.<kernel>: the kernels as custom ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def check_devices(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless the tensors lie on one CPU or CUDA device. On a CUDA
    device the custom op launches the kernel, on the CPU it runs the plain
    version (the dispatcher picks by device); no tensor of another device,
    and no mix, reaches either. The wrappers check once, here: a custom
    op's CUDA implementation is reached only with a CUDA tensor, from a
    wrapper or from a program traced on one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {device}")


def dtype_code(what: str, *tensors: torch.Tensor) -> int:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16 tensors "
                         f"of one dtype, got {dtypes}")
    return _DTYPE_CODES[dtypes.pop()]


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as the kernels' stream argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_channels_last(what: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: the kernel reads NHWC memory; pass a "
                         f"(B, C, H, W) tensor in torch.channels_last, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")


def channels_last_like(x: torch.Tensor, shape) -> torch.Tensor:
    """An uninitialized `shape` tensor of x's dtype and device in
    torch.channels_last: what the NHWC kernels write (and their fake
    implementations claim, so a traced program lays out what follows as the
    card will)."""
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)
