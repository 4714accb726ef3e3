"""The eval-mode generate function.

Counterpart of the JAX package's train/step.py for the serving path:
`ensure_m11_images` and `make_generate_fn`. The fused train step joins this
file with the training slice.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
)


def ensure_m11_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches -> per-image min-max to [-1, 1] in float32 (the compact
    feed); float batches pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    images = images.float()
    flat = images.reshape(images.shape[0], -1)
    mn = flat.amin(dim=1)[:, None, None, None]
    mx = flat.amax(dim=1)[:, None, None, None]
    return 2.0 * (images - mn) / torch.clamp(mx - mn, min=1e-12) - 1.0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (B, C, H, W) view of the same NHWC memory."""
    return x.permute(0, 3, 1, 2)


def make_generate_fn(generator: Generator, vgg: VGG16) -> Callable:
    """Eval-mode sampler: (images, masks, labels, noise) -> fakes.

    images (B, H, W, 3) float in [-1, 1] or uint8; masks the 7 shallow->deep
    levels, conv levels (B, h, w, 1); labels (B, num_classes) one-hot; noise
    (B, latent_dim). All NHWC as the JAX package's calling convention, on the
    models' device. Returns (B, H, W, 3) in the compute dtype."""
    if generator.training or vgg.training:
        raise ValueError("make_generate_fn needs eval-mode models (.eval())")

    def generate(images: torch.Tensor, masks: Sequence[torch.Tensor],
                 labels: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), exact_float32():
            features = vgg(_nchw(ensure_m11_images(images)))
            masks = [_nchw(m.float()) if m.dim() == 4 else m.float()
                     for m in masks]
            fakes = generator(noise.float(), features, masks, labels.float())
            return fakes.permute(0, 2, 3, 1)

    return generate
