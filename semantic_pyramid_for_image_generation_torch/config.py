"""Configurations of the models the port trains.

`PyramidGANConfig` is a copy of the JAX package's (same fields, defaults and
derived shapes), so a JAX artifact's manifest `config` echo builds this
dataclass unchanged. Shapes are per sample and NHWC, as the JAX package
documents them.

`BigGANDeepConfig` is BigGAN-deep (Brock, Donahue and Simonyan,
arXiv:1809.11096, appendix B), which the JAX package does not have: the
port trains it through the same Trainer (models/biggan_deep.py,
train/biggan_deep.py).
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


BOTTOM_WIDTH = 4  # G's first feature map is 4x4, at every resolution
# BigGAN-PyTorch's `G_arch` / `D_arch` (BigGANdeep.py): per stage, the
# (in, out) channel multipliers of ch and the resolution a stage ends at
_G_ARCH = {
    256: ((16, 16), (16, 8), (8, 8), (8, 4), (4, 2), (2, 1)),
    128: ((16, 16), (16, 8), (8, 4), (4, 2), (2, 1)),
    64: ((16, 16), (16, 8), (8, 4), (4, 2)),
}
_D_ARCH = {
    256: ((1, 2), (2, 4), (4, 8), (8, 8), (8, 16), (16, 16)),
    128: ((1, 2), (2, 4), (4, 8), (8, 16), (16, 16)),
    64: ((1, 2), (2, 4), (4, 8), (8, 16)),
}


@dataclasses.dataclass(frozen=True)
class BigGANDeepConfig:
    """BigGAN-deep as the paper's appendix B and the authors' BigGAN-PyTorch
    (`BigGANdeep.py`, `layers.py`, `train_fns.py`, `utils.py::ema`,
    `scripts/launch_BigGAN_deep.sh`) define it. Where the sources disagree
    or are silent:
      * `g_lr` 5e-5 and `d_lr` 2e-4 with two D steps per G step are the
        paper's appendix C settings; the launch script's 1e-4 / 4e-4 come
        with one D step. No learning rate changes the work a step does;
      * BN momentum 0.1 and eps 1e-5 are `layers.ccbn`'s and `layers.bn`'s
        defaults (`--BN_eps 1e-5`); SN eps 1e-6 and Adam eps 1e-6 are the
        launch script's `--SN_eps` and `--adam_eps`;
      * `ema_start` 20,000 is the launch script's; before it the EMA copies
        G, from it G_ema takes `ema_decay` 0.9999 (`utils.ema.update`);
      * `compute_dtype` is the port's: bfloat16 on the card with float32
        parameters and batch-norm arithmetic, as the Semantic Pyramid GAN
        runs (BigGAN-PyTorch trains in float32 by default).
    The networks' widths follow from `resolution` and `ch` by BigGAN-PyTorch's
    architecture tables (256, 128 and 64 here)."""

    resolution: int = 256
    ch: int = 128                      # G_ch and D_ch
    depth: int = 2                     # blocks per stage, G and D
    bottleneck_ratio: int = 4          # a block's hidden width: in/4 (G), out/4 (D)
    dim_z: int = 128
    shared_dim: int = 128              # the shared class embedding
    num_classes: int = 1000
    attention_resolution: int = 64
    num_d_steps: int = 2               # D updates per G update
    g_lr: float = 5e-5
    d_lr: float = 2e-4
    adam_betas: Tuple[float, float] = (0.0, 0.999)
    adam_eps: float = 1e-6
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    sn_eps: float = 1e-6
    ema_decay: float = 0.9999
    ema_start: int = 20_000
    attention_gamma: float = 0.0       # the attention's gamma at init
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.resolution not in _G_ARCH:
            raise ValueError(f"BigGANDeepConfig: resolution "
                             f"{self.resolution} not in {sorted(_G_ARCH)}")

    @property
    def cond_dim(self) -> int:
        """Width of [shared(y), z], the vector every batch norm reads."""
        return self.shared_dim + self.dim_z

    @property
    def generator_stages(self) -> Tuple[Tuple[int, int, int], ...]:
        """(in, out, resolution reached) of each G stage."""
        return tuple((self.ch * i, self.ch * o, BOTTOM_WIDTH * 2 ** (s + 1))
                     for s, (i, o) in enumerate(_G_ARCH[self.resolution]))

    @property
    def discriminator_stages(self) -> Tuple[Tuple[int, int, int], ...]:
        """(in, out, resolution reached) of each D stage."""
        return tuple((self.ch * i, self.ch * o, self.resolution // 2 ** (s + 1))
                     for s, (i, o) in enumerate(_D_ARCH[self.resolution]))

    def tiny(self) -> "BigGANDeepConfig":
        """A small config for CPU tests: 64x64 images, ch 8, attention at
        32x32, 16 classes, 16-wide z and embedding."""
        return dataclasses.replace(
            self, resolution=64, ch=8, attention_resolution=32,
            num_classes=16, dim_z=16, shared_dim=16)
