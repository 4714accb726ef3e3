"""The port's hand-written CUDA kernels, one wrapper module each.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors only, and counts its launches in a module-level
integer `launches`, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

from typing import Dict

from semantic_pyramid_for_image_generation_torch.ops.cuda import (
    attention,
    pool,
    resize,
)

KERNELS = {
    "pooled_kv_attention": attention,
    "max_pool_2x2": pool,
    "upsample_2x": resize,
}


def launch_counts() -> Dict[str, int]:
    return {name: module.launches for name, module in KERNELS.items()}


def reset_launch_counts() -> None:
    for module in KERNELS.values():
        module.launches = 0
