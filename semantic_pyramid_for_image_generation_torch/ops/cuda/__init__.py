"""The port's hand-written CUDA kernels, one wrapper module per source.

Each kernel is a torch custom op in the `spig` namespace (`torch.ops.spig.
max_pool_2x2`, ...): for CUDA tensors it launches the kernel and counts the
launch in a module-level integer, so a run can show that its path went
through the kernels; for CPU tensors only it runs the plain PyTorch
version. A program traced by `torch.export` keeps each call as one node, so
a loaded program launches (and counts) the same kernels. Importing this
package registers the ops; nothing is built before the first launch.
"""

from __future__ import annotations

from typing import Dict

from semantic_pyramid_for_image_generation_torch.ops.cuda import (
    attention,
    batch_norm,
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
    "batch_norm_stats": (batch_norm, "stats_launches"),
    "batch_norm_apply": (batch_norm, "apply_launches"),
    "batch_norm_backward_sums": (batch_norm, "backward_sums_launches"),
    "batch_norm_backward_dx": (batch_norm, "backward_dx_launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(module, counter)
            for name, (module, counter) in KERNELS.items()}


def reset_launch_counts() -> None:
    for module, counter in KERNELS.values():
        setattr(module, counter, 0)
