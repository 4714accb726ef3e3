"""Mask-level sweep grid rendering, a numpy copy of the JAX package's
eval/grid.py: per-sample min-max to [0, 1], then tiling with 2px padding like
torchvision.utils.save_image defaults. PIL is imported only to write PNGs.
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
