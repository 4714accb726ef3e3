"""What the three kernel wrappers share: device dispatch, dtype codes and the
stream handed to a kernel."""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def runs_kernel(what: str, *tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the kernel launches), False
    when they lie on the CPU (the plain version runs). Raises for mixed or
    other devices: no tensor of another device reaches a plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}")
    return True


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
