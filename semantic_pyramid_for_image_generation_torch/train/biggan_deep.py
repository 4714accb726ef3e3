"""BigGAN-deep's training: the state, its seeded init, the train step with
`num_d_steps` D updates per G update, the G EMA, and the family the
Trainer takes it by (`BIGGAN_DEEP`, train/family.py): checkpoints, the
eval-mode sampler and the grid.

The step is BigGAN-PyTorch's `train_fns.GAN_training_function` with one
gradient accumulation: each D update runs G with no gradients on fresh
latents and classes (training mode: G's u/v and batch-norm statistics
advance), then one D pass over fake ++ real (`G_D.forward`), the hinge loss,
its backward and Adam; the G update runs G with gradients on fresh latents
and classes, D on the fakes with D's parameters taking no gradients
(`toggle_grad`; D's u/v still advance), the hinge loss, G's backward and
Adam; then the EMA (`utils.ema.update`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import BigGANDeepConfig
from semantic_pyramid_for_image_generation_torch.models.biggan_deep import (
    BigGANDeepDiscriminator,
    BigGANDeepGenerator,
    make_biggan_deep,
)
from semantic_pyramid_for_image_generation_torch.train.losses import (
    hinge_discriminator_loss,
    hinge_generator_loss,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import span
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    _to_cpu,
    adam_state_dict_in_module_order,
    load_torch_file,
)

Batch = Dict[str, torch.Tensor]  # images (B, H, W, 3), labels (B,) indices


@dataclasses.dataclass
class BigGANDeepState:
    generator: BigGANDeepGenerator
    discriminator: BigGANDeepDiscriminator
    generator_ema: BigGANDeepGenerator  # eval mode; sampled by validation
    g_optimizer: torch.optim.Adam
    d_optimizer: torch.optim.Adam
    step: int = 0


def make_optimizers(generator: BigGANDeepGenerator,
                    discriminator: BigGANDeepDiscriminator
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """BigGAN's two Adams: betas, eps and the two learning rates of the
    networks' config."""
    cfg = generator.config
    return tuple(torch.optim.Adam(net.parameters(), lr=lr,
                                  betas=cfg.adam_betas, eps=cfg.adam_eps)
                 for net, lr in ((generator, cfg.g_lr),
                                 (discriminator, cfg.d_lr)))


def init_state(config: BigGANDeepConfig, device: torch.device,
               seed: int = 0) -> BigGANDeepState:
    """G and D drawn orthogonally from `seed` (models/biggan_deep.py), G_ema
    a copy of G (`utils.ema.__init__`), both Adams empty, step 0."""
    rng = torch.Generator(device).manual_seed(seed)
    generator, discriminator = make_biggan_deep(config, device, rng)
    with torch.device(device):
        generator_ema = BigGANDeepGenerator(config)
    generator_ema.to(memory_format=torch.channels_last)
    generator_ema.load_state_dict(generator.state_dict())
    generator_ema.requires_grad_(False).eval()
    return BigGANDeepState(generator, discriminator, generator_ema,
                           *make_optimizers(generator, discriminator))


def m11_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> x / 127.5 - 1 in float32, as a loader's
    `Normalize(0.5, 0.5)` of [0, 1] pixels; float images (already in
    [-1, 1]) pass through. Returns the (B, 3, H, W) view."""
    if images.dtype == torch.uint8:
        images = images.float() / 127.5 - 1.0
    return images.permute(0, 3, 1, 2)


def ema_decay(config: BigGANDeepConfig, step: int) -> float:
    """The EMA's decay after train step `step` (0 for the first):
    `utils.ema.update(itr)` with itr = step + 1 copies G before
    `ema_start`."""
    return 0.0 if step + 1 < config.ema_start else config.ema_decay


@torch.no_grad()
def update_ema(state: BigGANDeepState, decay: float) -> None:
    """G_ema <- G_ema * decay + G * (1 - decay) over every floating entry
    of G's state dict (parameters, u/v, running statistics), as
    `utils.ema.update` does."""
    source = state.generator.state_dict()
    pairs = [(t, source[k]) for k, t in state.generator_ema.state_dict().items()
             if t.is_floating_point()]
    targets, sources = [t for t, _ in pairs], [s for _, s in pairs]
    torch._foreach_mul_(targets, decay)
    torch._foreach_add_(targets, sources, alpha=1.0 - decay)


def _draw(rng: Optional[torch.Generator], rows: int,
          config: BigGANDeepConfig, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z ~ N(0, I), y uniform over the classes) for `rows` fakes."""
    z = torch.randn((rows, config.dim_z), generator=rng, device=device)
    y = torch.randint(0, config.num_classes, (rows,), generator=rng,
                      device=device)
    return z, y


def make_train_step() -> Callable[..., Tuple[BigGANDeepState,
                                             Dict[str, torch.Tensor]]]:
    """Build `(state, batch, rng) -> (state, metrics)`.

    `batch` holds `num_d_steps` chunks of real rows on the networks'
    device: images uint8 (scaled x / 127.5 - 1) or floats in [-1, 1],
    labels (B,) class indices. D update i takes chunk i; every update draws
    as many fakes as a chunk has rows. The latents and fake classes come
    from `rng` (a torch.Generator on the device; None uses torch's global
    generator) in a fixed order: z then y for each D update, then z then y
    for the G update.

    `state` is updated in place (the networks, both Adams, G_ema, `step`)
    and returned with the metrics as 0-d float32 tensors on the device: the
    last D update's hinge losses (`loss_discriminator_real`,
    `loss_discriminator_fake`), as BigGAN-PyTorch logs them, and
    `loss_generator`. float32 runs without TF32 (`exact_float32`).

    The step runs under the span `sp:step`; each D update under
    `sp:step.d_phase.{forward,backward,adam}`, the G update under
    `sp:step.g_phase.{forward,backward,adam}` and the EMA under
    `sp:step.ema` (utils/profiling.py::span)."""

    def train_step(state: BigGANDeepState, batch: Batch,
                   rng: Optional[torch.Generator] = None):
        with span("step"):
            return _step(state, batch, rng)

    def _step(state: BigGANDeepState, batch: Batch,
              rng: Optional[torch.Generator]):
        generator, discriminator = state.generator, state.discriminator
        cfg = generator.config
        generator.train()
        discriminator.train()
        with span("step.inputs"):
            images = m11_images(batch["images"])
            labels = batch["labels"].long()
        updates = cfg.num_d_steps
        if images.shape[0] % updates:
            raise ValueError(f"a batch of {images.shape[0]} rows does not "
                             f"split into {updates} D updates")
        rows, device = images.shape[0] // updates, images.device
        with exact_float32():
            for i in range(updates):
                with span("step.d_phase.forward"):
                    z, y = _draw(rng, rows, cfg, device)
                    with torch.no_grad():
                        fake = generator(z, y)
                    real = images[i * rows:(i + 1) * rows].to(fake.dtype)
                    pred = discriminator(
                        torch.cat([fake, real]),
                        torch.cat([y, labels[i * rows:(i + 1) * rows]]))
                    loss_d_real, loss_d_fake = hinge_discriminator_loss(
                        pred[:rows], pred[rows:])
                with span("step.d_phase.backward"):
                    state.d_optimizer.zero_grad(set_to_none=True)
                    (loss_d_real + loss_d_fake).backward()
                with span("step.d_phase.adam"):
                    state.d_optimizer.step()
            with span("step.g_phase.forward"):
                z, y = _draw(rng, rows, cfg, device)
                loss_g = hinge_generator_loss(discriminator(generator(z, y),
                                                            y))
            with span("step.g_phase.backward"):
                state.g_optimizer.zero_grad(set_to_none=True)
                loss_g.backward(inputs=list(generator.parameters()))
            with span("step.g_phase.adam"):
                state.g_optimizer.step()
        with span("step.ema"):
            update_ema(state, ema_decay(cfg, state.step))
        state.step += 1
        return state, {"loss_discriminator_real": loss_d_real.detach(),
                       "loss_discriminator_fake": loss_d_fake.detach(),
                       "loss_generator": loss_g.detach()}

    return train_step


class BigGANDeepFamily:
    """BigGAN-deep as the Trainer, its checkpoints and the CLI take it
    (train/family.py): `validate()` scores and `inference()` draws G_ema's
    samples, at the config's learning rates."""

    refusal = ("BigGAN-deep trains on one process without the SP-GAN's "
               "perf modes")
    refuses = ("multihost", "fsdp", "fused_discriminator", "remat_vgg",
               "remat_blocks")

    def init_state(self, config, device, seed, lr) -> BigGANDeepState:
        return init_state(config, device, seed)

    def make_step(self, **options) -> Callable:
        return make_train_step()

    def hyperparameters(self, lr, w_rec, w_div) -> Dict[str, str]:
        return {}

    def progress(self, fid: float, host: Dict[str, float]) -> str:
        return "FID={:.4f}, Loss G={:.4f}, Loss D={:.4f}".format(
            fid, host["loss_generator"], host["loss_discriminator_real"]
            + host["loss_discriminator_fake"])

    def latent_dim(self, config: BigGANDeepConfig) -> int:
        return config.dim_z

    def sample(self, state: BigGANDeepState, batch: Batch,
               noise: torch.Tensor) -> torch.Tensor:
        """G_ema's fakes (B, H, W, 3) for the batch's labels, in the compute
        dtype, under `torch.inference_mode`; G_ema must be in eval mode."""
        if state.generator_ema.training:
            raise ValueError("sampling needs an eval-mode G_ema")
        with torch.inference_mode(), exact_float32():
            return state.generator_ema(noise.float(), batch["labels"].long()
                                       ).permute(0, 2, 3, 1)

    def grid(self, config: BigGANDeepConfig, state: BigGANDeepState,
             images: np.ndarray, labels: np.ndarray, rng: torch.Generator,
             device: torch.device):
        """G_ema's samples, a row per label, a column per latent: as many
        columns as rows. Returns the grid and its row length."""
        n = labels.shape[0]
        y = torch.as_tensor(np.repeat(labels, n)).to(device)
        z = torch.randn((n * n, config.dim_z), generator=rng, device=device)
        return self.sample(state, {"labels": y}, z).float().cpu().numpy(), n

    def checkpoint(self, state: BigGANDeepState) -> Dict[str, Any]:
        """G, D and G_ema state dicts and both Adam state dicts on the CPU,
        and the step."""
        return {**{net: _to_cpu(getattr(state, net).state_dict())
                   for net in ("generator", "discriminator", "generator_ema")},
                "generator_optimizer": adam_state_dict_in_module_order(
                    state.g_optimizer, state.generator),
                "discriminator_optimizer": adam_state_dict_in_module_order(
                    state.d_optimizer, state.discriminator),
                "step": int(state.step)}

    def restore(self, path: str, state: BigGANDeepState) -> BigGANDeepState:
        """`checkpoint`'s file into `state` in place (strict keys)."""
        checkpoint = load_torch_file(path)
        for net in ("generator", "discriminator", "generator_ema"):
            getattr(state, net).load_state_dict(checkpoint[net], strict=True)
        state.g_optimizer.load_state_dict(checkpoint["generator_optimizer"])
        state.d_optimizer.load_state_dict(checkpoint["discriminator_optimizer"])
        state.step = int(checkpoint["step"])
        return state


BIGGAN_DEEP = BigGANDeepFamily()
