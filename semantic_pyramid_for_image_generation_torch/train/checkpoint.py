"""Checkpoint and resume, counterpart of the JAX package's train/checkpoint.py.

The port's one format is the reference `.pt` layout
(`utils/pt_interop.py::save_reference_gan_checkpoint`): G and D state dicts
(parameters, spectral u/v, batch-norm statistics) and both torch Adam state
dicts, plus the step. The JAX package reads these files with
`--load_checkpoint x.pt`, and the port reads the reference's and the JAX
package's `.pt` files (`restore_checkpoint`). The frozen VGG is not saved:
it comes from its own file (`--load_pretrained_vgg16`) or the seed.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from semantic_pyramid_for_image_generation_torch.train.state import (
    TrainState,
    import_adam_moments,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    load_reference_gan_checkpoint,
    save_reference_gan_checkpoint,
)

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def save_checkpoint(directory: str, state: TrainState,
                    step: Optional[int] = None) -> str:
    """Write `<directory>/checkpoint_<step:03d>.pt` (the step defaults to
    `state.step`), overwriting a file of that name as torch.save does."""
    step = int(state.step) if step is None else step
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"checkpoint_{step:03d}.pt"))
    save_reference_gan_checkpoint(path, state)
    return path


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a reference-layout `.pt` into `state` in place (strict keys; Adam
    moments mapped by parameter key) and return it. The step is the file's
    `step`, else its Adam step count (the reference layout has no step)."""
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the port reads reference-layout .pt checkpoints only; "
            "convert an orbax checkpoint with the JAX package's "
            "cli/convert_checkpoint.py orbax-to-pt (the port's own "
            "cli/convert_checkpoint.py is a later item)")
    ckpt = load_reference_gan_checkpoint(path)
    state.generator.load_state_dict(ckpt["generator"], strict=True)
    state.discriminator.load_state_dict(ckpt["discriminator"], strict=True)
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
