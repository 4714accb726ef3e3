"""The port's hand-written CUDA kernels, one wrapper module per source.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors only, and counts its launches in a module-level
integer, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from semantic_pyramid_for_image_generation_torch.ops.cuda import (
    attention,
    pool,
    resize,
)

# kernel name -> (wrapper module, name of its launch counter)
KERNELS = {
    "pooled_kv_attention": (attention, "launches"),
    "max_pool_2x2": (pool, "launches"),
    "upsample_2x": (resize, "launches"),
    "max_pool_2x2_backward": (pool, "backward_launches"),
    "upsample_2x_backward": (resize, "backward_launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(module, counter)
            for name, (module, counter) in KERNELS.items()}


def reset_launch_counts() -> None:
    for module, counter in KERNELS.values():
        setattr(module, counter, 0)
