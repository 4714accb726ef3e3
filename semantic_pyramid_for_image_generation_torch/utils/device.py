"""Device selection and the float32 numerics the port runs under."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """torch.device(name); raises when CUDA is asked for and absent, so no
    entry point continues on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device cpu (or device='cpu') to run on the CPU")
    return device


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions without TF32 (cuDNN allows TF32 by default);
    float32 matmuls must not use TF32 either."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is set; "
                           "the float32 parity mode needs full float32")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        yield
