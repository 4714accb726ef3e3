"""Training objectives, all in float32.

Counterpart of the JAX package's train/losses.py:
  * masked multi-level semantic reconstruction (L1 on 2x-max-pooled
    features; the conv levels pool through Kernels 2 and 4 on CUDA),
  * mini-batch diversity (latent L1 over image L1),
  * LSGAN generator and discriminator least-squares objectives;
and BigGAN's hinge objectives (BigGAN-PyTorch's `losses.loss_hinge_dis` /
`loss_hinge_gen`), which the JAX package does not have.

Every loss is a plain mean over the global batch, as the JAX package reduces
them. Over several ranks (parallel/mesh.py) each rank returns its share: its
rows' part of the global mean, so the ranks' shares sum to the loss of the
concatenated batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from semantic_pyramid_for_image_generation_torch.ops.pool import (
    max_pool_1d,
    max_pool_2d,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    all_gather_rows,
    world_size,
)


def _share(value: torch.Tensor) -> torch.Tensor:
    """This rank's 1/world share of a value (the value at world size 1)."""
    world = world_size()
    return value if world == 1 else value / world


def _mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global mean of x: its local mean over the
    world size (every rank holds the same number of rows)."""
    return _share(torch.mean(x))


def semantic_reconstruction_loss(features_real: Sequence[torch.Tensor],
                                 features_fake: Sequence[torch.Tensor],
                                 masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over pyramid levels of mean(|real - fake| * mask) after 2x max
    pooling of features AND masks. Conv levels are (B, C, H, W) with
    (B, 1, H, W) masks broadcasting over channels; vector levels pool pairwise
    along the feature axis."""
    if not len(features_real) == len(features_fake) == len(masks):
        raise ValueError("features and masks must have the same levels")
    loss = torch.zeros((), dtype=torch.float32, device=masks[0].device)
    for real, fake, mask in zip(features_real, features_fake, masks):
        real, fake, mask = real.float(), fake.float(), mask.float()
        pool = max_pool_2d if real.dim() == 4 else max_pool_1d
        real, fake, mask = pool(real), pool(fake), pool(mask)
        loss = loss + _mean_share(torch.abs(real - fake) * mask)
    return loss


def diversity_loss(images_fake: torch.Tensor,
                   latents: torch.Tensor) -> torch.Tensor:
    """L1(z1, z2) / (L1(img1, img2) + 1e-8) over the two halves of the
    global batch; pushes distinct noises to distinct images. Over several
    ranks the halves pair rows of different ranks: every rank gathers the
    fakes (with their gradient) and the latents, computes the ratio, and
    takes 1/world of it, so the ranks' shares sum to the ratio; the
    gather's backward hands each rank its rows of the ratio's gradient."""
    images_fake = all_gather_rows(images_fake)
    latents = all_gather_rows(latents)
    b = images_fake.shape[0]
    if b < 2:
        raise ValueError("the diversity loss needs a batch of at least 2")
    half = b // 2
    img1 = images_fake[:half].float()
    img2 = images_fake[half:2 * half].float()
    z1 = latents[:half].float()
    z2 = latents[half:2 * half].float()
    l1_latent = torch.mean(torch.abs(z1 - z2))
    l1_images = torch.mean(torch.abs(img1 - img2))
    return _share(l1_latent / (l1_images + 1e-8))


def lsgan_generator_loss(prediction_fake: torch.Tensor) -> torch.Tensor:
    """0.5 * mean((D(fake) - 1)^2)."""
    return 0.5 * _mean_share(torch.square(prediction_fake.float() - 1.0))


def lsgan_discriminator_loss(prediction_real: torch.Tensor,
                             prediction_fake: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real part, fake part), summed by the caller."""
    loss_real = 0.5 * _mean_share(
        torch.square(prediction_real.float() - 1.0))
    loss_fake = 0.5 * _mean_share(torch.square(prediction_fake.float()))
    return loss_real, loss_fake


def hinge_discriminator_loss(prediction_fake: torch.Tensor,
                             prediction_real: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean(relu(1 - D(real))), mean(relu(1 + D(fake)))): the real and the
    fake part, summed by the caller; fake first in the arguments, as
    BigGAN-PyTorch's `loss_hinge_dis(dis_fake, dis_real)` takes them."""
    loss_real = _mean_share(torch.relu(1.0 - prediction_real.float()))
    loss_fake = _mean_share(torch.relu(1.0 + prediction_fake.float()))
    return loss_real, loss_fake


def hinge_generator_loss(prediction_fake: torch.Tensor) -> torch.Tensor:
    """-mean(D(fake))."""
    return -_mean_share(prediction_fake.float())
