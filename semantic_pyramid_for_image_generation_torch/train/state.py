"""The train state: the three networks, the two optimizers and the step.

Counterpart of the JAX package's train/state.py. There the whole state is
one pytree threaded through a pure step; here the networks hold their own
mutable state (parameters, spectral u/v buffers, batch-norm running
statistics) and the train step advances it in place, in the JAX order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import (
    DEFAULT_LR,
    PyramidGANConfig,
)
from semantic_pyramid_for_image_generation_torch.models import (
    make_discriminator,
    make_models,
)
from semantic_pyramid_for_image_generation_torch.models.discriminator import (
    Discriminator,
)
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    fsdp_dim,
    is_dtensor,
    shard_like,
    shard_state,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    discriminator_state_dict_from_flax,
    generator_state_dict_from_flax,
    parameter_keys,
    vgg16_state_dict_from_flax,
)


@dataclasses.dataclass
class TrainState:
    generator: Generator
    discriminator: Discriminator
    vgg: VGG16  # frozen feature extractor
    g_optimizer: torch.optim.Adam
    d_optimizer: torch.optim.Adam
    step: int = 0


class ShardedAdam(torch.optim.Adam):
    """Adam over a mix of sharded and whole parameters (parallel/mesh.py::
    shard_state). torch's multi-tensor Adam, its default on the card,
    cannot take sharded and whole tensors in one call, so each step updates
    the sharded parameters of every group, then the whole ones, with the
    same hyperparameters; the state keeps one param group, as the reference
    checkpoint layout has it."""

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ShardedAdam.step takes no closure")
        everything = [group["params"] for group in self.param_groups]
        try:
            for sharded in (True, False):
                for group, params in zip(self.param_groups, everything):
                    group["params"] = [p for p in params
                                       if is_dtensor(p) == sharded]
                super().step()
        finally:
            for group, params in zip(self.param_groups, everything):
                group["params"] = params


def make_optimizers(generator: nn.Module, discriminator: nn.Module,
                    lr: float = DEFAULT_LR
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam with torch defaults (b1 0.9, b2 0.999, eps 1e-8), one per net:
    the update optax.adam makes (`ShardedAdam` over a sharded net)."""
    return tuple(
        (ShardedAdam if any(is_dtensor(p) for p in net.parameters())
         else torch.optim.Adam)(net.parameters(), lr=lr, betas=(0.9, 0.999),
                                eps=1e-8)
        for net in (generator, discriminator))


def init_train_state(config: PyramidGANConfig, device: torch.device,
                     lr: float = DEFAULT_LR, seed: int = 0,
                     g_variables: Optional[Mapping[str, Any]] = None,
                     d_variables: Optional[Mapping[str, Any]] = None,
                     vgg_variables: Optional[Mapping[str, Any]] = None,
                     mesh=None) -> TrainState:
    """The three networks on `device`, random-init from `seed` with the flax
    initializers, or bridged from JAX variables (`{params, spectral,
    batch_stats}` trees of arrays, as the JAX package's state holds them).
    G and D are in training mode; the VGG is frozen (eval mode, no
    parameter gradients) but stays differentiable in its input. With a
    (data, fsdp) `mesh` (parallel/mesh.py::make_mesh) the state is sharded
    over it (`shard_state`): every rank must build the same state."""
    rng = torch.Generator(device).manual_seed(seed)
    generator, vgg = make_models(config, device, rng)
    discriminator = make_discriminator(config, device, rng)
    bridges = ((generator, g_variables, generator_state_dict_from_flax),
               (discriminator, d_variables, discriminator_state_dict_from_flax),
               (vgg, vgg_variables, vgg16_state_dict_from_flax))
    for module, variables, bridge in bridges:
        if variables is not None:
            module.load_state_dict(bridge(variables), strict=True)
    vgg.requires_grad_(False)
    generator.train()
    discriminator.train()
    g_optimizer, d_optimizer = make_optimizers(generator, discriminator, lr)
    state = TrainState(generator, discriminator, vgg, g_optimizer, d_optimizer)
    return state if mesh is None else shard_state(state, mesh)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def state_bytes(state) -> Dict[str, int]:
    """This rank's bytes of G's, D's and the VGG's parameters and of both
    Adam states' moments (exp_avg, exp_avg_sq; none before a first step):
    a sharded tensor counts its part on this rank."""
    def local(t: torch.Tensor) -> int:
        t = t.to_local() if is_dtensor(t) else t
        return t.numel() * t.element_size()

    params = sum(local(p) for net in (state.generator, state.discriminator,
                                      state.vgg) for p in net.parameters())
    moments = sum(local(slot[k])
                  for opt in (state.g_optimizer, state.d_optimizer)
                  for slot in opt.state.values()
                  for k in ("exp_avg", "exp_avg_sq") if k in slot)
    return {"parameters": params, "adam_moments": moments}


def sharded_state_bytes(state, fsdp: int) -> Dict[str, int]:
    """`state_bytes` worked out from the networks' shapes (any device,
    `meta` included) for a rank at `fsdp`, with both Adam states' moments
    present: each leaf that `fsdp_dim` shards counts 1/fsdp of itself."""
    def share(net) -> Tuple[int, int]:
        total = trained = 0
        for name, p in net.named_parameters():
            n = p.numel() * p.element_size()
            if fsdp_dim(name, p.shape, fsdp) is not None:
                n //= fsdp
            total += n
            trained += n if p.requires_grad else 0
        return total, trained

    params = moments = 0
    for net in (state.generator, state.discriminator, state.vgg):
        total, trained = share(net)
        params += total
        moments += 2 * trained
    return {"parameters": params, "adam_moments": moments}


def import_adam_moments(optimizer: torch.optim.Adam, module: nn.Module,
                        optimizer_state: Mapping[str, Any],
                        model_state: Mapping[str, Any]) -> Optional[int]:
    """Load a torch Adam state dict from a reference-layout checkpoint into
    `optimizer` (built on `module.parameters()`), mapped by key: the file's
    integer ids index the parameter keys of the file's own `model_state` in
    order, and each key names one of the port's parameters. The writer's key
    order need not be the port's `parameters()` order (the JAX package
    writes its export order, which puts each attention's `gamma` after its
    convolutions), so a positional `optimizer.load_state_dict` would put
    moments on the wrong tensors.

    torch adopts the file's param_groups, its `lr` included, as the
    reference's resume does. An empty optimizer state (nothing trained yet)
    clears the optimizer's. Returns the file's Adam step count, None when
    empty. The moments of a sharded parameter are placed as it is
    (`shard_like`). Counterpart of the JAX package's
    `inject_adam_moments`."""
    slots = optimizer_state.get("state") or {}
    if not slots:
        optimizer.state.clear()
        return None
    groups = optimizer_state["param_groups"]
    if len(groups) != 1:
        raise ValueError(f"expected one Adam param group, got {len(groups)}")
    keys = parameter_keys(model_state)
    if len(groups[0]["params"]) != len(keys):
        raise ValueError(
            f"optimizer state covers {len(groups[0]['params'])} parameters "
            f"but the model state dict has {len(keys)}")
    id_of = dict(zip(keys, groups[0]["params"]))
    params = dict(module.named_parameters())
    if set(params) != set(keys):
        raise ValueError("the checkpoint's parameter keys are not the "
                         f"module's: {sorted(set(params) ^ set(keys))[:4]}")
    state, step = {}, 0
    for i, (name, param) in enumerate(params.items()):
        slot = slots.get(id_of[name])
        if slot is None:
            continue
        slot = dict(slot)
        for moment in ("exp_avg", "exp_avg_sq"):
            if tuple(slot[moment].shape) != tuple(param.shape):
                raise ValueError(f"{name}: {moment} {tuple(slot[moment].shape)}"
                                 f" for a parameter of {tuple(param.shape)}")
            slot[moment] = shard_like(slot[moment], param)
        state[i] = slot
        step = int(slot["step"])
    optimizer.load_state_dict({
        "state": state,
        "param_groups": [dict(groups[0], params=list(range(len(params))))]})
    return step
