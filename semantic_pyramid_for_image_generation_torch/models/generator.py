"""Semantic-pyramid generator.

Counterpart of the JAX package's models/generator.py. Pipeline: SN-Linear
latent->latent; LinearBlock injecting masked fc8; LinearBlock injecting
masked fc7 (-> 2048); the channel-major (B, 128, 4, 4) view; lrelu + SN-1x1
to 512 channels; five upsampling GeneratorResidualBlocks consuming masked
pool5..pool1 (with the mask concatenated) and one SelfAttention after the
third; final block (up2x -> BN -> lrelu -> SN3x3 -> lrelu -> SN1x1) and tanh.

Keys follow the reference layout (`main_path.0..5` with the attention at
`main_path.3`, `final_block.1/3/5`, ...). 29,967,047 parameters at full
width. With `config.remat_blocks` each residual block runs under
`layers.remat` (its activations recomputed in the backward), as the JAX
package wraps them in `nn.remat`; the attention and the linear and final
blocks are not wrapped.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.layers import (
    LEAKY_SLOPE,
    BatchNorm,
    GeneratorResidualBlock,
    LinearBlock,
    SelfAttention,
    SNConv2d,
    SNLinear,
    Upsample2x,
    remat,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
    compute_dtype,
)

_ATTENTION_AFTER = 2  # SelfAttention sits after the third block


class Generator(nn.Module):
    def __init__(self, config: PyramidGANConfig = PyramidGANConfig()):
        super().__init__()
        cfg = config
        self.config = config
        blocks = cfg.generator_block_channels
        self.linear_layer = SNLinear(cfg.latent_dim, cfg.latent_dim)
        self.linear_block_1 = LinearBlock(cfg.latent_dim, cfg.num_classes,
                                          cfg.num_classes)
        self.linear_block_2 = LinearBlock(cfg.num_classes, 2048,
                                          cfg.vgg_fc7_dim)
        self.convolution_layer = nn.ModuleList([
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(128, blocks[0][0], 1, padding=0)])
        # block i consumes the pool level 4 - i (deep -> shallow)
        feature_channels = cfg.vgg_conv_channels[::-1]
        main_path = []
        for i, (cin, cout) in enumerate(blocks):
            main_path.append(GeneratorResidualBlock(
                cin, cout, cfg.num_classes, feature_channels[i]))
            if i == _ATTENTION_AFTER:
                main_path.append(SelfAttention(cout))
        self.main_path = nn.ModuleList(main_path)
        last = blocks[-1][1]
        self.final_block = nn.ModuleList([
            Upsample2x(),
            BatchNorm(last),
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(last, last),
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(last, cfg.out_channels, 1, padding=0),
            nn.Tanh(),
        ])

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    def forward(self, latent: torch.Tensor, features: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor],
                class_onehot: torch.Tensor) -> torch.Tensor:
        """latent (B, latent_dim); features and masks: the 7 pyramid levels
        shallow->deep, conv levels (B, C, H, W) and masks (B, 1, H, W),
        vector levels (B, D); class_onehot (B, num_classes). Returns
        (B, 3, 256, 256) in the compute dtype, channels_last."""
        if len(features) != 7 or len(masks) != 7:
            raise ValueError("the pyramid has 7 levels of features and masks")
        dtype = self.dtype
        x = self.linear_layer(latent.to(dtype))
        x = self.linear_block_1(x, (features[6] * masks[6]).to(dtype))
        x = self.linear_block_2(x, (features[5] * masks[5]).to(dtype))
        # the torch view (B, 128, 4, 4) of the 2048-vector
        x = x.reshape(x.shape[0], 128, 4, 4).contiguous(
            memory_format=torch.channels_last)
        act, conv = self.convolution_layer
        x = conv(act(x))
        depth = 4
        for module in self.main_path:
            if isinstance(module, SelfAttention):
                x = module(x)
                continue
            feat, mask = features[depth].to(dtype), masks[depth].to(dtype)
            masked = torch.cat([feat * mask, mask], dim=1)
            if self.config.remat_blocks:
                x = remat(module, x, masked, class_onehot)
            else:
                x = module(x, masked, class_onehot)
            depth -= 1
        up, bn, act, conv_1, act_1, conv_2, tanh = self.final_block
        x = bn(up(x), act.negative_slope)  # the BN applies the LeakyReLU
        return tanh(conv_2(act_1(conv_1(x))))

