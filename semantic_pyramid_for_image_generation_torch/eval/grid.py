"""Mask-level sweep grid rendering, a numpy copy of the JAX package's
eval/grid.py: per-sample min-max to [0, 1], then tiling with 2px padding like
torchvision.utils.save_image defaults. PIL is imported only to write PNGs.
`sweep_masks` and `sweep_stack` lay a whole sweep out as one level-major
batch and back in grid order (the Trainer's one 49-row generate).
"""

from __future__ import annotations

import numpy as np


def tile_grid(images: np.ndarray, nrow: int = 7, padding: int = 2) -> np.ndarray:
    """(N, H, W, C) in [0,1] -> tiled (H', W', C) uint8 grid image."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = int(np.ceil(n / ncol))
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[idx]
    return (np.clip(grid, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def normalize_0_1_np(images: np.ndarray) -> np.ndarray:
    flat = images.reshape(images.shape[0], -1)
    mn = flat.min(axis=1)[:, None, None, None]
    mx = flat.max(axis=1)[:, None, None, None]
    return (images - mn) / np.maximum(mx - mn, 1e-12)


def sweep_masks(schedule, num_images: int, levels: int = 7) -> tuple:
    """The masks of a mask-level sweep as one batch of levels * num_images
    rows, level-major: rows [l * n, (l + 1) * n) hold level l's one-hot
    inference masks (`schedule` is a data/masks.py MaskSchedule)."""
    level_masks = [schedule.inference_masks(level) for level in range(levels)]
    return tuple(
        np.concatenate([np.broadcast_to(lm[p][None], (num_images,) + lm[p].shape)
                        for lm in level_masks], 0)
        for p in range(len(level_masks[0])))


def sweep_stack(fakes: np.ndarray, num_images: int) -> np.ndarray:
    """Level-major sweep output -> the grid's row-major order: row = image,
    column = mask level."""
    levels = fakes.shape[0] // num_images
    return fakes.reshape((levels, num_images) + fakes.shape[1:]).swapaxes(
        0, 1).reshape(fakes.shape)


def save_inference_grid(
    images: np.ndarray,
    path: str,
    nrow: int = 7,
) -> None:
    """Normalize per-sample like the reference (normalize_0_1_batch min-maxes
    each of the 49 fakes independently, misc.py:100-109) and write a PNG."""
    from PIL import Image

    grid = tile_grid(normalize_0_1_np(images), nrow=nrow)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    Image.fromarray(grid).save(path)
