"""VGG-16: the GAN's frozen feature-pyramid extractor (eval mode) and the
fine-tuned Places365 classifier (training mode, with dropout).

Counterpart of the JAX package's models/vgg16.py. Returns the 7-level
semantic pyramid: the activations after each of the 5 max pools
(shallow->deep, Kernel 2 forward and Kernel 4 backward on CUDA), ReLU(fc7)
and the fc8 logits, or only the logits with `return_output=True`.

Inputs are (B, 3, H, W) in [-1, 1] (per-image min-max), then
ImageNet-standardized in float32, as the reference does. The module tree is
torchvision's `features` / `classifier` under a `vgg16.` prefix, the keys the
JAX package's `export_vgg16_state_dict` emits, so reference `.pt` files and
exported JAX parameters load with `strict=True`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.layers import (
    lecun_normal_,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import (
    adaptive_avg_pool_2d,
    max_pool_2d,
)

# torchvision vgg16 feature plan: out channels for convs, 'M' for pools
_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class MaxPool2x2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2d(x)


class _TorchvisionVGG16(nn.Module):
    """torchvision's vgg16 layout (features.0 ... features.30,
    classifier.0/3/6) at widths divided by `width_factor`."""

    def __init__(self, width_factor: int, num_classes: int):
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(MaxPool2x2())
            else:
                layers += [nn.Conv2d(in_ch, item // width_factor, 3, padding=1),
                           nn.ReLU()]
                in_ch = item // width_factor
        self.features = nn.Sequential(*layers)
        fc = 4096 // width_factor
        self.classifier = nn.Sequential(
            nn.Linear(in_ch * 7 * 7, fc), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(fc, fc), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(fc, num_classes))


class VGG16(nn.Module):
    def __init__(self, config: PyramidGANConfig = PyramidGANConfig(),
                 return_output: bool = False):
        super().__init__()
        self.config = config
        self.return_output = return_output
        self.vgg16 = _TorchvisionVGG16(config.vgg_width_factor,
                                       config.num_classes)
        self.initialize()

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        """flax init: lecun-normal kernels, zero biases."""
        for m in self.vgg16.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, rng)
                m.bias.zero_()

    def forward(self, images: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Training mode (`.train()`, the fine-tune) applies the classifier's
        two Dropout(0.5) layers, after ReLU(fc6) and after the fc7 tap, with
        keep masks drawn from `dropout_rng` (a torch.Generator on the
        images' device; None uses torch's global generator) or given as
        `dropout_masks` (two boolean (B, fc) tensors, True = kept). Eval
        mode applies none."""
        dtype = self.dtype
        x = images
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        mean = torch.tensor(_IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(_IMAGENET_STD, device=x.device)[:, None, None]
        x = ((x.float() - mean) / std).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)

        features: List[torch.Tensor] = []
        for layer in self.vgg16.features:
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(dtype), layer.bias.to(dtype),
                             padding=1)
            elif isinstance(layer, nn.ReLU):
                x = F.relu(x)
            else:
                x = layer(x)
                features.append(x)

        x = adaptive_avg_pool_2d(x, 7, 7)
        x = torch.flatten(x, 1)  # channel-major, as torch flattens NCHW
        fc6, fc7, fc8 = (self.vgg16.classifier[i] for i in (0, 3, 6))
        masks = list(dropout_masks) if dropout_masks is not None else None
        x = F.relu(F.linear(x, fc6.weight.to(dtype), fc6.bias.to(dtype)))
        x = self._dropout(x, dropout_rng, masks)
        x = F.relu(F.linear(x, fc7.weight.to(dtype), fc7.bias.to(dtype)))
        # the fc7 tap is ReLU(fc7), before the second dropout: the
        # reference's in-place ReLU mutates the tapped tensor
        features.append(x)
        x = self._dropout(x, dropout_rng, masks)
        x = F.linear(x, fc8.weight.to(dtype), fc8.bias.to(dtype))
        features.append(x)
        if self.return_output:
            return x
        return features

    def _dropout(self, x: torch.Tensor, rng: Optional[torch.Generator],
                 masks: Optional[List[torch.Tensor]]) -> torch.Tensor:
        """flax Dropout(0.5): where(keep, x / 0.5, 0), keep ~ Bernoulli(0.5)."""
        if not self.training:
            return x
        keep = (masks.pop(0) if masks is not None
                else dropout_keep_mask(x.shape, x.device, rng))
        return torch.where(keep, x / 0.5, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def dropout_keep_mask(shape, device: torch.device,
                      rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """A boolean keep mask of Dropout(0.5), each element kept with
    probability 1/2, drawn from `rng` on `device`."""
    return torch.rand(shape, generator=rng, device=device) < 0.5


def compute_dtype(config: PyramidGANConfig) -> torch.dtype:
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{config.compute_dtype!r}")
    return getattr(torch, config.compute_dtype)
