"""Configuration for the semantic-pyramid GAN.

A copy of the JAX package's `PyramidGANConfig` (same fields, defaults and
derived shapes), so a JAX artifact's manifest `config` echo builds this
dataclass unchanged. Shapes are per sample and NHWC, as the JAX package
documents them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _scaled(c: int, factor: float) -> int:
    """Channel scaling with the reference's `int(c // factor)` semantics."""
    return int(c // factor)


@dataclasses.dataclass(frozen=True)
class PyramidGANConfig:
    # --- image / class space -------------------------------------------------
    image_size: int = 256              # output resolution (fixed 4*2^6 pipeline)
    out_channels: int = 3
    num_classes: int = 365             # Places365
    latent_dim: int = 128

    # --- width scaling -------------------------------------------------------
    channels_factor: float = 1.0       # reference --channel_factor
    vgg_width_factor: int = 1          # divides VGG conv/fc7 widths (tests only)

    # --- mask schedule --------------------------------------------------------
    p_random_mask: float = 0.3

    # --- behavior switches ---------------------------------------------------
    compat_projection: bool = True
    bn_cross_replica: bool = True

    # --- dtypes --------------------------------------------------------------
    # Computation dtype ('float32' | 'bfloat16'). Params and norm statistics
    # always stay float32.
    compute_dtype: str = "float32"
    remat_blocks: bool = False

    # ------------------------------------------------------------------------
    # Derived architecture contract
    # ------------------------------------------------------------------------
    @property
    def vgg_conv_channels(self) -> Tuple[int, ...]:
        """Channels of the 5 VGG pool taps, shallow->deep."""
        f = self.vgg_width_factor
        return (64 // f, 128 // f, 256 // f, 512 // f, 512 // f)

    @property
    def vgg_fc7_dim(self) -> int:
        return 4096 // self.vgg_width_factor

    @property
    def pyramid_spatial(self) -> Tuple[int, ...]:
        """Spatial dims of the 5 conv pyramid levels, shallow->deep."""
        s = self.image_size
        return (s // 2, s // 4, s // 8, s // 16, s // 32)

    @property
    def feature_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-sample NHWC feature shapes, shallow->deep (7 levels)."""
        convs = tuple(
            (hw, hw, c)
            for hw, c in zip(self.pyramid_spatial, self.vgg_conv_channels)
        )
        return convs + ((self.vgg_fc7_dim,), (self.num_classes,))

    @property
    def mask_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-sample mask shapes, shallow->deep. Conv masks are (H, W, 1)."""
        convs = tuple((hw, hw, 1) for hw in self.pyramid_spatial)
        return convs + ((self.vgg_fc7_dim,), (self.num_classes,))

    @property
    def generator_block_channels(self) -> Tuple[Tuple[int, int], ...]:
        """(in, out) channels of the 5 generator residual blocks, deep->shallow."""
        cf = self.channels_factor
        c512, c256, c128, c64 = (
            _scaled(512, cf), _scaled(256, cf), _scaled(128, cf), _scaled(64, cf))
        return ((c512, c512), (c512, c512), (c512, c256), (c256, c128), (c128, c64))

    @property
    def generator_attention_channels(self) -> int:
        return _scaled(256, self.channels_factor)

    @property
    def discriminator_block_channels(self) -> Tuple[Tuple[int, int], ...]:
        """(in, out) of the discriminator's input block and 6 residual
        blocks."""
        c = lambda x: _scaled(x, self.channels_factor)  # noqa: E731
        return ((self.out_channels, c(64)), (c(64), c(128)), (c(128), c(256)),
                (c(256), c(256)), (c(256), c(256)), (c(256), c(512)),
                (c(512), c(768)))

    def tiny(self) -> "PyramidGANConfig":
        """A width-reduced config for CPU tests."""
        return dataclasses.replace(
            self, channels_factor=8.0, vgg_width_factor=8, num_classes=16)


# Training defaults of the reference (batch size, learning rate, weights of
# the semantic reconstruction and diversity losses, validation images of a
# FID), as the JAX package's config has them.
DEFAULT_BATCH_SIZE = 20
DEFAULT_LR = 1e-5
DEFAULT_W_REC = 0.1
DEFAULT_W_DIV = 0.1
DEFAULT_FID_VAL_IMAGES = 6000
