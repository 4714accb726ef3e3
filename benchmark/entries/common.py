"""What the entries share: the seed's streams, the program's configuration
from a configuration file, the training readings the reference is held to,
the gaps between two sets of readings, and the training cells' controls and
planted faults."""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from benchmark.reference import gan as ref_gan
from benchmark.weights import make_weights

BETA1 = 0.9  # Adam's first-moment decay in the program's optimizers
CHANGE_LEAF_FLOOR = 1e-3  # leaves whose reference gradient is under this
# share of the median leaf's move by round-off alone: left out of the
# gradient's and the change's gaps
GRAD_QUANTILE = 0.9  # the leaf of `grad_p90_gap`, by its gap, low to high


def stream(seed: int, index: int) -> int:
    """A 64-bit seed of its own for the run's `index`-th use of `seed`."""
    words = np.random.SeedSequence((seed, index)).generate_state(2, np.uint32)
    return int(words[0]) << 32 | int(words[1])


def program_config(config: dict):
    """The program's PyramidGANConfig for a configuration file."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )

    return PyramidGANConfig(
        image_size=config["image_size"], num_classes=config["num_classes"],
        latent_dim=config.get("latent_dim", 128),
        channels_factor=float(config.get("channels_factor", 1.0)),
        vgg_width_factor=int(config.get("vgg_width_factor", 1)),
        compat_projection=bool(config.get("compat_projection", True)),
        compute_dtype=config["compute_dtype"],
        p_random_mask=float(config.get("p_random_mask", 0.3)))


def gan_weights(config: dict, seed: int, device: torch.device,
                nets=("generator", "discriminator", "vgg")) -> Dict[str, dict]:
    """The state dicts of the GAN's networks, made from the seed."""
    widths = ref_gan.Widths(config)
    specs = {"generator": ref_gan.generator_spec,
             "discriminator": ref_gan.discriminator_spec,
             "vgg": ref_gan.vgg_spec}
    return {net: make_weights(specs[net](widths), stream(seed, 10 + i),
                              device)
            for i, net in enumerate(specs) if net in nets}


def adam_first_grads(optimizer: torch.optim.Optimizer, module
                     ) -> Dict[str, torch.Tensor]:
    """The first step's gradient of each parameter, as the optimizer got it:
    its first moment after one step over (1 - beta1)."""
    out = {}
    for name, p in module.named_parameters():
        slot = optimizer.state.get(p)
        if slot and "exp_avg" in slot:
            out[name] = slot["exp_avg"].detach().float() / (1.0 - BETA1)
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    if not keys:
        return {}
    values = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                          for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keys) -> List[float]:
    """Per leaf of `keys`, the gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's (some gradients are all but zero)."""
    keys = list(keys)
    median = statistics.median(reference[k] for k in keys)
    return [abs(program.get(k, 0.0) - reference[k])
            / max(reference[k], median, 1e-30) for k in keys]


def training_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers a training cell can be held to, from readings {"losses":
    [per step {name: value}], "grads": {group: {leaf: norm}}, "change":
    {group: {leaf: norm}}, "output": step 1's first output}: the relative
    L2 error of that output (`first_output_err`), each checked step's
    losses (`loss_gap`; the
    first step's alone, before any update, `first_loss_gap`), the first
    gradients and the change of the parameters over the checked steps, by
    the worst leaf (`grad_gap`, `change_gap`), by the median leaf
    (`grad_median_gap`, `change_median_gap`) and, for the gradients, by the
    leaf at GRAD_QUANTILE of their gaps (`grad_p90_gap`: the worst leaf but
    one tenth of them, where the worst is one small leaf's round-off and
    the median is blind to losses taken over part of the rows, which move
    only the leaves fed by rows). Leaves whose reference
    gradient is under CHANGE_LEAF_FLOOR of the median leaf's are left out of
    both. The cell's limits file says which are compared."""
    def loss_gaps(steps):
        gaps = [abs(p[name] - r) / max(abs(r), 1e-30)
                if math.isfinite(p[name]) else math.inf
                for p, rs in steps for name, r in rs.items()]
        return max(gaps) if gaps else math.inf

    pairs = list(zip(program["losses"], reference["losses"]))
    out = {"loss_gap": loss_gaps(pairs), "first_loss_gap": loss_gaps(pairs[:1])}
    if len(program["losses"]) != len(reference["losses"]):
        out["loss_gap"] = math.inf
    grads, change = [], []
    for group, r_grads in reference["grads"].items():
        median = statistics.median(r_grads.values())
        moved = [k for k, g in r_grads.items()
                 if g >= CHANGE_LEAF_FLOOR * median]
        grads += leaf_gaps(program["grads"][group], r_grads, moved)
        change += leaf_gaps(program["change"][group],
                            reference["change"][group], moved)
    out.update(grad_gap=max(grads), grad_median_gap=statistics.median(grads),
               grad_p90_gap=sorted(grads)[min(len(grads) - 1,
                                              int(GRAD_QUANTILE * len(grads)))],
               change_gap=max(change),
               change_median_gap=statistics.median(change),
               first_output_err=relative_error(program.get("output"),
                                               reference.get("output")))
    return out


def relative_error(got, want) -> float:
    """||got - want|| / ||want|| in float64; infinite when either is
    missing or their shapes differ."""
    if got is None or want is None or got.shape != want.shape:
        return math.inf
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(min=1e-300))


class FirstOutput:
    """Keeps the output of a module's first call, as float32, and removes
    its hook then (holding no reference to the module)."""

    def __init__(self, module: torch.nn.Module):
        self.value = None
        self._hook = module.register_forward_hook(self._keep)

    def _keep(self, module, args, output):
        self.value = output.detach().float().clone()
        self._hook.remove()


def changes(params: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    return {k: params[k].detach().float() - start[k] for k in params}


# A training cell's controls, each the reference in the program's place:
# float8 operands (the precision below the configurations' bfloat16), and
# the planted faults the cell can have, the losses over half of the batch's
# rows and a learning rate of 0 (the state left unchanged).
TRAINING_CONTROLS = ("fp8", "half_batch", "no_update")


def training_control(control: str, batch: int) -> dict:
    """The keyword arguments that plant `control` in an entry's
    `reference_readings` for a cell of `batch` rows a step."""
    return {"fp8": {"precision": "fp8"},
            "half_batch": {"batch_rows": batch // 2},
            "no_update": {"lr": 0.0}}[control]


def drop_updates(optimizers) -> None:
    """A planted fault: every optimizer step a no-op."""
    for opt in optimizers:
        opt.step = lambda *args, **kwargs: None


def _first_rows(x):
    """The first half of the rows of a tensor, or of each in a sequence."""
    if isinstance(x, (list, tuple)):
        return type(x)(_first_rows(t) for t in x)
    return x[:x.shape[0] // 2] if isinstance(x, torch.Tensor) else x


def losses_on_half_batch(owner, attr: str, module, names) -> None:
    """A planted fault: while `owner.attr` (the program's step) runs, each
    loss `module.<name>` takes the mean over the first half of its rows
    alone; the forwards still run on every row."""
    patches = [mock.patch.object(module, name, _on_first_rows(
        getattr(module, name))) for name in names]
    inner = getattr(owner, attr)

    def half(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            return inner(*args, **kwargs)

    setattr(owner, attr, half)


def _on_first_rows(loss):
    return lambda *args: loss(*(_first_rows(a) for a in args))
