"""Synthetic batches over the full pyramid contract, for tests and the chip
smoke; no dataset needed. A copy of the JAX package's data/synthetic.py:
the same seed gives the same numpy batch."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule


def synthetic_batch(config: PyramidGANConfig, batch: int,
                    rng: Optional[np.random.Generator] = None,
                    validation: bool = False) -> Dict[str, Any]:
    """Random images in [-1, 1] (B, H, W, 3), one-hot labels, and a
    per-sample mask draw (the training schedule unless `validation`): the
    batch dict the train step takes, as numpy arrays."""
    rng = np.random.default_rng(0) if rng is None else rng
    s = config.image_size
    images = rng.uniform(-1.0, 1.0,
                         (batch, s, s, config.out_channels)).astype(np.float32)
    labels = np.eye(config.num_classes, dtype=np.float32)[
        rng.integers(0, config.num_classes, size=batch)]
    schedule = MaskSchedule(config)
    draw = schedule.validation_masks if validation else schedule.training_masks
    masks = schedule.batch([draw(rng) for _ in range(batch)])
    return {"images": images, "labels": labels, "masks": tuple(masks)}
