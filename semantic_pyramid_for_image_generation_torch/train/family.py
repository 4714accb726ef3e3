"""The model a Trainer trains: one family object per trained model, chosen
by the one lookup on its config's type (`family_of`). It holds all that the
Trainer (train/loop.py), its checkpoints (train/checkpoint.py) and the CLI
(cli/main.py) need of its model:
  refuses, refusal   the options it does not run; the message's head
  init_state(config, device, seed=, lr=)  the state: generator,
                     discriminator, g_optimizer, d_optimizer, step
  make_step(w_rec=, w_div=, remat_vgg=, fused_discriminator=)  the
                     (state, batch, rng) -> (state, metrics) step
  hyperparameters(lr, w_rec, w_div), progress(fid, host)  logged, shown
  latent_dim(config), sample(state, batch, latents)  validate()'s fakes
  grid(config, state, images, labels, rng, device)  inference()'s grid
                     and its row length
  checkpoint(state), restore(path, state)  the checkpoint dict, its restore
Optional, the SP-GAN's alone: generate(state, batch, noise) and
import_adam_moments(state, checkpoint), behind the Trainer's methods of
those names, which raise ValueError where the family lacks them.
A family is stateless, and one object serves every Trainer of its model
(`trainer.family`): patch a copy given to one Trainer, never the object.
"""

from __future__ import annotations

from semantic_pyramid_for_image_generation_torch.config import (
    BigGANDeepConfig,
    PyramidGANConfig,
)
from semantic_pyramid_for_image_generation_torch.train.biggan_deep import (
    BIGGAN_DEEP,
)
from semantic_pyramid_for_image_generation_torch.train.step import SP_GAN

FAMILIES = {PyramidGANConfig: SP_GAN, BigGANDeepConfig: BIGGAN_DEEP}


def family_of(config, **asked: bool):
    """The family of `config`'s type. Raises ValueError, with the family's
    `refusal`, for each option of `asked` that is on and that it refuses."""
    family = FAMILIES[type(config)]
    refused = [name for name in family.refuses if asked.get(name)]
    if refused:
        raise ValueError(f"{family.refusal}; refused: {', '.join(refused)}")
    return family
