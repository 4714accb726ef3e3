"""Semantic-pyramid mask schedule (paper 3.2), a numpy copy of the JAX
package's data/masks.py.

Masks select which pyramid levels condition the generator. Per sample:

  * a stage is drawn from range(7) + [0, 1] over the DEEP->SHALLOW ordering, so
    the two deepest levels (fc8, fc7) are double-weighted;
  * the selected stage gets an all-ones mask, deeper stages all-zeros;
  * with probability 0.3 (interior stages only) the shallower stages get a
    spatially-varying binary mask: random shapes rasterized at the
    next-shallower stage's resolution (1-4 shapes; 1 outside the shapes, 0
    inside), broadcast to each shallower stage by nearest interpolation;
  * otherwise shallower stages get all-zeros (pure one-hot schedule).

Masks are generated on the host in numpy. Conv masks are per-sample
(H, W, 1), NHWC as the JAX package's calling convention.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    interpolate_nearest_np,
)


def _rasterize_random_shapes(rng: np.random.Generator, height: int, width: int,
                             min_shapes: int = 1, max_shapes: int = 4,
                             min_size: int = 8) -> np.ndarray:
    """Binary (H, W) mask: 1 on background, 0 inside 1..4 random shapes
    (rectangle / circle / triangle), overlap allowed."""
    min_size = min(min_size, height // 2)
    min_size = max(min_size, 1)
    occupied = np.zeros((height, width), dtype=bool)
    yy, xx = np.mgrid[0:height, 0:width]
    for _ in range(rng.integers(min_shapes, max_shapes + 1)):
        size_h = int(rng.integers(min_size, max(height, min_size + 1)))
        size_w = int(rng.integers(min_size, max(width, min_size + 1)))
        r0 = int(rng.integers(0, max(height - size_h, 0) + 1))
        c0 = int(rng.integers(0, max(width - size_w, 0) + 1))
        kind = rng.integers(0, 3)
        if kind == 0:  # rectangle
            occupied[r0:r0 + size_h, c0:c0 + size_w] = True
        elif kind == 1:  # ellipse inscribed in the box
            cy, cx = r0 + size_h / 2.0, c0 + size_w / 2.0
            ry, rx = max(size_h / 2.0, 0.5), max(size_w / 2.0, 0.5)
            occupied |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        else:  # triangle: apex mid-top of the box, base at the bottom
            h_span = max(size_h - 1, 1)
            rel_y = (yy - r0) / h_span
            half_base = (size_w / 2.0) * rel_y
            cx = c0 + size_w / 2.0
            inside = (yy >= r0) & (yy < r0 + size_h) & \
                     (np.abs(xx - cx) <= half_base)
            occupied |= inside
    return (~occupied).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MaskSchedule:
    """Mask generator bound to a pyramid contract (shapes from config)."""

    config: PyramidGANConfig = PyramidGANConfig()

    @property
    def p_random_mask(self) -> float:
        return self.config.p_random_mask

    @property
    def shapes(self) -> Tuple[Tuple[int, ...], ...]:
        return self.config.mask_shapes  # shallow -> deep, conv masks (H, W, 1)

    def _build(self, selected_stage: int, spatial_mask: Optional[np.ndarray]
               ) -> List[np.ndarray]:
        """Assemble the 7 masks. `selected_stage` indexes DEEP->SHALLOW
        (0 = fc8), matching the reference's reversed iteration."""
        deep_first = list(reversed(self.shapes))
        masks: List[np.ndarray] = []
        for index, shape in enumerate(deep_first):
            if index == selected_stage:
                masks.append(np.ones(shape, dtype=np.float32))
            elif index < selected_stage:
                masks.append(np.zeros(shape, dtype=np.float32))
            elif spatial_mask is None:
                masks.append(np.zeros(shape, dtype=np.float32))
            else:
                h, w = shape[0], shape[1]
                masks.append(
                    interpolate_nearest_np(spatial_mask, h, w)[:, :, None])
        masks.reverse()  # back to shallow->deep, matching the feature list
        return masks

    def training_masks(self, rng: np.random.Generator) -> List[np.ndarray]:
        n = len(self.shapes)
        # range(n) + [0, 1]: fc8/fc7 double-weighted (misc.py:28)
        selected_stage = int(rng.choice(list(range(n)) + [0, 1]))
        spatial = (rng.random() < self.p_random_mask) and (0 < selected_stage < n - 1)
        spatial_mask = None
        if spatial:
            # rasterize at the next-shallower stage's resolution (misc.py:37-41)
            deep_first = list(reversed(self.shapes))
            h, w = deep_first[selected_stage + 1][0], deep_first[selected_stage + 1][1]
            spatial_mask = _rasterize_random_shapes(rng, h, w)
        return self._build(selected_stage, spatial_mask)

    def validation_masks(self, rng: np.random.Generator) -> List[np.ndarray]:
        """One-hot mask at a uniformly random stage (misc.py:71-75)."""
        return self._build(int(rng.integers(0, len(self.shapes))), None)

    def inference_masks(self, stage_index: int) -> List[np.ndarray]:
        """Deterministic one-hot mask; stage indexes deep->shallow
        (misc.py:78-97)."""
        return self._build(stage_index, None)

    def batch(self, per_sample: Sequence[List[np.ndarray]]) -> List[np.ndarray]:
        """Stack per-sample mask lists into a 7-element batched list."""
        return [np.stack([s[i] for s in per_sample], axis=0)
                for i in range(len(self.shapes))]


# Functional forms of the reference's mask API (misc.py), as the JAX
# package's data/masks.py has them: a numpy Generator with the same seed gives
# the same arrays.
_DEFAULT = MaskSchedule()


def get_masks_for_training(rng: Optional[np.random.Generator] = None,
                           schedule: MaskSchedule = _DEFAULT
                           ) -> List[np.ndarray]:
    rng = np.random.default_rng() if rng is None else rng
    return schedule.training_masks(rng)


def get_masks_for_validation(rng: Optional[np.random.Generator] = None,
                             schedule: MaskSchedule = _DEFAULT
                             ) -> List[np.ndarray]:
    rng = np.random.default_rng() if rng is None else rng
    return schedule.validation_masks(rng)


def get_masks_for_inference(stage_index: int,
                            schedule: MaskSchedule = _DEFAULT,
                            batch: Optional[int] = None) -> List[np.ndarray]:
    """The one-hot masks of `stage_index` (deep -> shallow), with a leading
    batch axis of `batch` rows when it is given."""
    masks = schedule.inference_masks(stage_index)
    if batch is not None:
        masks = [np.broadcast_to(m[None], (batch,) + m.shape).copy()
                 for m in masks]
    return masks
