"""Checkpoint and resume, counterpart of the JAX package's train/checkpoint.py.

The port's one format is the reference `.pt` layout
(`utils/pt_interop.py::reference_gan_checkpoint`): G and D state dicts
(parameters, spectral u/v, batch-norm statistics) and both torch Adam state
dicts, plus the step. The JAX package reads these files with
`--load_checkpoint x.pt`, and the port reads the reference's and the JAX
package's `.pt` files (`restore_checkpoint`). The frozen VGG is not saved:
it comes from its own file (`--load_pretrained_vgg16`) or the seed.

A BigGAN-deep state (train/biggan_deep.py) is saved under the same names in
the port's own layout: G, D and G_ema state dicts, both Adam state dicts as
torch writes them, and the step (`biggan_deep.checkpoint_dict`).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    check_replicated,
    is_sharded,
    load_state_dict_,
    tree_digest,
)
from semantic_pyramid_for_image_generation_torch.train import biggan_deep
from semantic_pyramid_for_image_generation_torch.train.state import (
    TrainState,
    import_adam_moments,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    load_reference_gan_checkpoint,
    load_torch_file,
    reference_gan_checkpoint,
)

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def save_checkpoint(directory: str, state: TrainState,
                    step: Optional[int] = None, write: bool = True
                    ) -> Optional[str]:
    """Write `<directory>/checkpoint_<step:03d>.pt` (the step defaults to
    `state.step`), overwriting a file of that name as torch.save does, and
    return its path. A sharded state is gathered whole on every rank, so
    every rank calls this, and only the one with `write` writes (the others
    return None): the file is the one the unsharded state writes."""
    step = int(state.step) if step is None else step
    if not (write or is_sharded(state.generator)):
        return None
    checkpoint = (biggan_deep.checkpoint_dict(state)
                  if isinstance(state, biggan_deep.BigGANDeepState)
                  else reference_gan_checkpoint(state))
    if not write:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"checkpoint_{step:03d}.pt"))
    torch.save(checkpoint, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a reference-layout `.pt` into `state` in place (strict keys; Adam
    moments mapped by parameter key) and return it. The step is the file's
    `step`, else its Adam step count (the reference layout has no step).
    A sharded state takes its part of each whole tensor of the file, at any
    fsdp (parallel/mesh.py::load_state_dict_); every rank reads the file
    from its own disk, and the ranks raise unless they read the same one
    (each would hold its part of another state)."""
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the port reads reference-layout .pt checkpoints only; "
            "convert an orbax checkpoint with the JAX package's "
            "cli/convert_checkpoint.py orbax-to-pt (orbax is a JAX "
            "library; the port's cli/convert_checkpoint.py has no orbax "
            "modes)")
    if isinstance(state, biggan_deep.BigGANDeepState):
        return biggan_deep.load_checkpoint_dict(state, load_torch_file(path))
    ckpt = load_reference_gan_checkpoint(path)
    if is_sharded(state.generator):
        check_replicated(file=tree_digest(ckpt))
    load_state_dict_(state.generator, ckpt["generator"])
    load_state_dict_(state.discriminator, ckpt["discriminator"])
    adam_step = None
    for optimizer, net in ((state.g_optimizer, "generator"),
                           (state.d_optimizer, "discriminator")):
        adam_step = import_adam_moments(
            optimizer, getattr(state, net), ckpt[f"{net}_optimizer"],
            ckpt[net]) or adam_step
    state.step = ckpt.get("step", adam_step or 0)
    return state


def latest_checkpoint(directory: str) -> Optional[str]:
    """The `checkpoint_<n>.pt` with the largest n under `directory`."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(directory)
             if (m := _NAME.match(name))]
    if not found:
        return None
    return os.path.join(directory, max(found)[1])
