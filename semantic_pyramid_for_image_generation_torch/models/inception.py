"""InceptionV3 feature extractor for FID, counterpart of the JAX package's
models/inception.py.

The torchvision `Inception3` architecture (transform_input=False) from the
stem through Mixed_7c, then a global mean to (B, 2048) in float32. Module
and parameter names are torchvision's (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_var`, ...), so a torchvision `inception_v3`
state dict loads with `strict=True` once its `AuxLogits.*` and `fc.*` keys
are dropped (`torchvision_features_state_dict`).

BasicConv2d = bias-free conv, BatchNorm (eps 1e-3) from its running
statistics, ReLU. The pools are PyTorch's: max 3x3 stride 2 without
padding, and avg 3x3 stride 1 pad 1 dividing by 9 everywhere
(count_include_pad). No port kernel runs here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from semantic_pyramid_for_image_generation_torch.models.layers import (
    lecun_normal_,
)


class BasicConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn  # always the running statistics: a frozen backbone
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=bn.eps)
        return F.relu(x)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avg_pool(x))], 1)


class InceptionV3Features(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> the pooled Mixed_7c activations (B, 2048),
    float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        """The JAX package's random init: lecun-normal conv kernels, BN scale
        1, bias 0, running mean 0, running var 1."""
        for module in self.modules():
            if isinstance(module, BasicConv2d):
                lecun_normal_(module.conv.weight, rng)
                module.bn.reset_parameters()


def make_inception(device: torch.device,
                   state_dict: Optional[Mapping[str, Any]] = None,
                   rng: Optional[torch.Generator] = None) -> InceptionV3Features:
    """InceptionV3Features on `device`, eval mode, channels_last, frozen:
    from a torchvision-named `state_dict`, else a random init from `rng`."""
    with torch.device(device):
        model = InceptionV3Features()
    if state_dict is not None:
        model.load_state_dict(torchvision_features_state_dict(state_dict),
                              strict=True)
    else:
        model.initialize(rng)
    return model.to(memory_format=torch.channels_last).eval().requires_grad_(False)


def torchvision_features_state_dict(
        sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A torchvision inception_v3 state dict without what FID does not run
    (`AuxLogits.*`, `fc.*`)."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("AuxLogits.", "fc."))}
