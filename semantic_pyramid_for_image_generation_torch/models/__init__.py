"""The Generator, the Discriminator and the frozen VGG-16 pyramid."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.discriminator import (
    Discriminator,
)
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    initialize_,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16


def make_models(config: PyramidGANConfig, device: torch.device,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[Generator, VGG16]:
    """(Generator, VGG16) on `device`, in eval mode and channels_last memory.
    With `rng` (a torch.Generator on `device`) every weight is drawn from it
    with the flax initializers, so a seed fixes a random-init model."""
    with torch.device(device):
        generator, vgg = Generator(config), VGG16(config)
    if rng is not None:
        initialize_(generator, rng)
        initialize_(vgg, rng)
    generator.to(memory_format=torch.channels_last).eval()
    vgg.to(memory_format=torch.channels_last).eval()
    return generator, vgg


def make_discriminator(config: PyramidGANConfig, device: torch.device,
                       rng: Optional[torch.Generator] = None) -> Discriminator:
    """The Discriminator on `device`, in eval mode and channels_last memory;
    with `rng` every weight is drawn from it, as `make_models` does."""
    with torch.device(device):
        discriminator = Discriminator(config)
    if rng is not None:
        initialize_(discriminator, rng)
    return discriminator.to(memory_format=torch.channels_last).eval()
