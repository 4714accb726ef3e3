"""SAGAN-style projection discriminator.

Counterpart of the JAX package's models/discriminator.py. Input residual
block 3->64, six downsampling residual blocks 64->128->256->[SelfAttention
at 32x32x256]->256->256->512->768, lrelu, global average pool, SN-Linear
768->128, lrelu; then the SN-Linear 128->1 `classification` head plus the
spectrally-normalized class embedding projection.

`compat_projection=True` (the default) keeps the reference's broadcast:
score (B, 1) + x (B, 128) * emb (B, 1, 128) gives (B, B, 128), out[i, j] =
score[j] + x[j] * emb[i]; the LSGAN losses mean over all of it. Over
several ranks (parallel/mesh.py) i runs over the global batch and j over
this rank's rows: (B_global, B, 128).
`compat_projection=False` gives the canonical (B, 1) score + <x, emb>.

Keys follow the reference layout (`layers.0..11`, `classification`,
`embedding`), as the JAX package's `export_discriminator_state_dict` emits
them. 16,820,994 parameters at full width. With `config.remat_blocks` the
input block and the six residual blocks run under `layers.remat`, as the
JAX package wraps them in `nn.remat`; the attention and the head are not
wrapped.
"""

from __future__ import annotations

import torch
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.layers import (
    LEAKY_SLOPE,
    DiscriminatorInputResidualBlock,
    DiscriminatorResidualBlock,
    GlobalAvgPool,
    SelfAttention,
    SNEmbedding,
    SNLinear,
    remat,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
    compute_dtype,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    all_gather_rows,
)

_ATTENTION_AFTER = 2  # SelfAttention sits after the 256-channel block 2
PROJECTION_FEATURES = 128


class Discriminator(nn.Module):
    def __init__(self, config: PyramidGANConfig = PyramidGANConfig()):
        super().__init__()
        self.config = config
        blocks = config.discriminator_block_channels
        layers = [DiscriminatorInputResidualBlock(*blocks[0])]
        for i, (cin, cout) in enumerate(blocks[1:], start=1):
            layers.append(DiscriminatorResidualBlock(cin, cout))
            if i == _ATTENTION_AFTER:
                layers.append(SelfAttention(cout))
        layers += [nn.LeakyReLU(LEAKY_SLOPE), GlobalAvgPool(), nn.Flatten(),
                   SNLinear(blocks[-1][1], PROJECTION_FEATURES),
                   nn.LeakyReLU(LEAKY_SLOPE)]
        self.layers = nn.ModuleList(layers)
        self.classification = SNLinear(PROJECTION_FEATURES, 1)
        self.embedding = SNEmbedding(config.num_classes, PROJECTION_FEATURES)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    def forward(self, images: torch.Tensor,
                class_onehot: torch.Tensor) -> torch.Tensor:
        """images (B, 3, 256, 256), class_onehot (B, num_classes) -> (B, B, 128)
        ((B_global, B, 128) over several ranks) with compat_projection, else
        (B, 1); in the compute dtype."""
        dtype = self.dtype
        x = images.to(dtype).contiguous(memory_format=torch.channels_last)
        for layer in self.layers:
            if self.config.remat_blocks and isinstance(
                    layer, (DiscriminatorInputResidualBlock,
                            DiscriminatorResidualBlock)):
                x = remat(layer, x)
            else:
                x = layer(x)
        labels = class_onehot.argmax(dim=-1)
        if self.config.compat_projection:
            # emb over the global batch's i: every rank's labels (the
            # embedding is replicated), so a rank returns (B_global, B, 128)
            labels = all_gather_rows(labels)
        emb = self.embedding(labels).to(dtype)
        score = self.classification(x)
        if self.config.compat_projection:
            return score + x * emb[:, None, :]
        return score + (x * emb).sum(dim=-1, keepdim=True)
