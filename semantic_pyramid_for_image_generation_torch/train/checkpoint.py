"""Checkpoint and resume, counterpart of the JAX package's train/checkpoint.py.

The SP-GAN's format is the reference `.pt` layout
(`utils/pt_interop.py::reference_gan_checkpoint`): G and D state dicts
(parameters, spectral u/v, batch-norm statistics) and both torch Adam state
dicts, plus the step. The JAX package reads these files with
`--load_checkpoint x.pt`, and the port reads the reference's and the JAX
package's `.pt` files (`restore_checkpoint`). The frozen VGG is not saved:
it comes from its own file (`--load_pretrained_vgg16`) or the seed.

What a file holds is the family's of the state's model (train/family.py:
`checkpoint`, `restore`); the files' names and cadence are this module's.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    is_sharded,
)
from semantic_pyramid_for_image_generation_torch.train.family import family_of

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def save_checkpoint(directory: str, state: Any,
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
    checkpoint = family_of(state.generator.config).checkpoint(state)
    if not write:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"checkpoint_{step:03d}.pt"))
    torch.save(checkpoint, path)
    return path


def restore_checkpoint(path: str, state: Any) -> Any:
    """Load a `.pt` into `state` in place (strict keys) and return it. The
    SP-GAN's Adam moments map by parameter key, and its step is the file's
    `step`, else its Adam step count (the reference layout has no step). A
    sharded state takes its part of each whole tensor of the file, at any
    fsdp (parallel/mesh.py::load_state_dict_); the ranks raise unless they
    read the same file, each from its own disk."""
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the port reads reference-layout .pt checkpoints only; "
            "convert an orbax checkpoint with the JAX package's "
            "cli/convert_checkpoint.py orbax-to-pt (orbax is a JAX "
            "library; the port's cli/convert_checkpoint.py has no orbax "
            "modes)")
    return family_of(state.generator.config).restore(path, state)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The `checkpoint_<n>.pt` with the largest n under `directory`."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(directory)
             if (m := _NAME.match(name))]
    if not found:
        return None
    return os.path.join(directory, max(found)[1])
