"""The fused G/D train step, the eval-mode generate function and the
SP-GAN's family (`SP_GAN`, train/family.py).

Counterpart of the JAX package's train/step.py: `ensure_m11_images`,
`make_train_step` and `make_generate_fn` (its body, `generate_nhwc`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from semantic_pyramid_for_image_generation_torch.config import (
    DEFAULT_W_DIV,
    DEFAULT_W_REC,
)
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
from semantic_pyramid_for_image_generation_torch.eval.grid import (
    sweep_masks,
    sweep_stack,
)
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    set_spectral_update_,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    all_reduce_gradients,
    check_replicated,
    global_rows,
    is_sharded,
    load_state_dict_,
    sum_metrics,
    tree_digest,
)
from semantic_pyramid_for_image_generation_torch.train.losses import (
    diversity_loss,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
    semantic_reconstruction_loss,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    TrainState,
    import_adam_moments,
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import span
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    load_reference_gan_checkpoint,
    reference_gan_checkpoint,
)

Batch = Dict[str, Any]  # images (B,H,W,3), labels (B,classes), masks: 7-tuple
GRID_LEVELS = 7


def ensure_m11_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches -> per-image min-max to [-1, 1] in float32 (the compact
    feed); float batches pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    images = images.float()
    flat = images.reshape(images.shape[0], -1)
    mn = flat.amin(dim=1)[:, None, None, None]
    mx = flat.amax(dim=1)[:, None, None, None]
    return 2.0 * (images - mn) / torch.clamp(mx - mn, min=1e-12) - 1.0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (B, C, H, W) view of the same NHWC memory."""
    return x.permute(0, 3, 1, 2)


def _float_masks(masks: Sequence[torch.Tensor]) -> list:
    """Masks as float, conv levels (B, h, w, 1) as the (B, 1, h, w) view."""
    return [_nchw(m.float()) if m.dim() == 4 else m.float() for m in masks]


def batch_to_device(batch: Mapping[str, Any], device: torch.device) -> Batch:
    """A numpy batch (data/synthetic.py, or the same keys from a loader) as
    tensors on `device`, the masks (where the batch has them) a tuple. A
    sharded loader's host-side `shard_rows` stays behind."""
    def put(a):
        return torch.as_tensor(np.asarray(a)).to(device)
    with span("loop.to_device"):
        out = {k: put(v) for k, v in batch.items()
               if k not in ("masks", "shard_rows")}
        if "masks" in batch:
            out["masks"] = tuple(put(m) for m in batch["masks"])
    return out


def discriminate_fused(discriminator: torch.nn.Module, images: torch.Tensor,
                       fake: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D's scores of the real and the fake rows from one pass over real ++
    fake (2B rows), each half with the batch's labels: one advance of D's
    u/v where the separate passes take two."""
    b = images.shape[0]
    pred = discriminator(torch.cat([images.to(fake.dtype), fake]),
                         torch.cat([labels, labels]))
    return pred[:b], pred[b:]


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """`module`'s parameters take no gradients for the duration."""
    wanted = [(p, p.requires_grad) for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, requires_grad in wanted:
            p.requires_grad_(requires_grad)


def backward_generator(loss: torch.Tensor, generator: Generator) -> None:
    """G's parameter gradients of the G phase's `loss`, and no others.
    Unsharded, the backward takes G's parameters as its `inputs`. Sharded
    (parallel/mesh.py::shard_state), `parameters()` are the shards, which
    the graph does not hold (FSDP gathers a copy for each use), so `inputs`
    would give G no gradients: D is frozen for the phase instead
    (`frozen`), the VGG always is, and the backward runs over the whole
    graph."""
    if is_sharded(generator):
        loss.backward()
    else:
        loss.backward(inputs=list(generator.parameters()))


def make_train_step(w_rec: float = DEFAULT_W_REC,
                    w_div: float = DEFAULT_W_DIV,
                    remat_vgg: bool = False,
                    fused_discriminator: bool = False,
                    spectral_update: bool = True
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the fused `(state, batch, rng) -> (state, metrics)` step.

    One step, in the JAX package's state-advance order:
      1. the frozen VGG-16 pyramid of the real batch (no gradients);
      2. D phase: a no-grad, training-mode G forward on noise_d (advances
         G's u/v and batch-norm statistics), D on real then on fake (two
         advances of D's u/v; one pass and one advance with
         `fused_discriminator`), the LSGAN D loss, an Adam step of D;
      3. G phase: G with gradients on noise_g (G's second advance), the
         *updated* D on the fakes (D's third advance), a second VGG forward
         on the fakes, the LSGAN, diversity and masked semantic
         reconstruction losses, and an Adam step of G. The backward computes
         G's parameter gradients only.

    `state` is updated in place (networks, optimizers, `step`) and returned
    with the five metrics under the reference logger's names, as 0-d
    float32 tensors on the device. `batch` holds tensors on the networks'
    device (`batch_to_device`); it may pin the per-phase latents as
    `noise_d` / `noise_g`, else they are drawn from `rng` (a
    torch.Generator on the device; None uses torch's global generator).

    remat_vgg: the G phase's VGG forward on the fakes keeps none of its
    activations; the backward recomputes it (`torch.utils.checkpoint`, as
    the JAX step's `jax.checkpoint`). The VGG holds no state that a forward
    advances.

    fused_discriminator: the D phase runs D once on real ++ fake (2B rows)
    and splits the scores, so D's u/v advance once in the D phase, twice per
    step. Needs the canonical projection (`compat_projection=False`, else
    ValueError): the (B, B, 128) broadcast pairs rows across the batch and
    cannot be split. With spectral updates frozen the step computes what
    the separate passes compute, up to the summation order of a 2B-row
    batch. Over several ranks each rank fuses its own rows.

    Residual blocks are recomputed in the backward when the networks'
    config has `remat_blocks` (models/layers.py::remat); the recompute runs
    inside the step's `exact_float32`, as the forward does.

    The step and each of its phases (the inputs, the pyramid, and the
    forward, backward and Adam step of each phase) run under their spans
    (utils/profiling.py::span), which cost a flag check with no profiler
    recording.

    spectral_update: the test switch of the JAX step; False freezes u/v
    (every sigma reuses the stored vectors). float32 runs without TF32 in
    the forward and the backward (`exact_float32`).

    Over several ranks (parallel/mesh.py) `batch` holds this rank's rows of
    the global batch, every rank the same number; the step computes what
    one rank computes on the concatenated batch. The latents are drawn for
    the global batch from `rng` (seeded alike on every rank) and sliced to
    this rank's rows; pinned latents are this rank's rows. Each gradient is
    summed over the ranks before its Adam step, and the metrics are the
    global losses on every rank.

    A state sharded over a (data, fsdp) mesh (parallel/mesh.py::shard_state)
    steps the same way: FSDP gathers each unit's leaves for its forwards and
    backwards and sums their gradients, and the G phase freezes D
    (`backward_generator`)."""

    def train_step(state: TrainState, batch: Batch,
                   rng: Optional[torch.Generator] = None):
        with span("step"):
            return _step(state, batch, rng)

    def _step(state: TrainState, batch: Batch,
              rng: Optional[torch.Generator]):
        generator, discriminator, vgg = (state.generator, state.discriminator,
                                         state.vgg)
        if fused_discriminator and discriminator.config.compat_projection:
            raise ValueError("fused_discriminator needs compat_projection="
                             "False: the (B, B, 128) projection pairs rows "
                             "across the batch and cannot be split")
        generator.train()
        discriminator.train()
        vgg.eval()
        for net in (generator, discriminator):
            set_spectral_update_(net, spectral_update)
        with span("step.inputs"):
            images = _nchw(ensure_m11_images(batch["images"]))
            labels = batch["labels"].float()
            masks = _float_masks(batch["masks"])
        b, latent_dim = images.shape[0], generator.config.latent_dim

        def noise(key: str) -> torch.Tensor:
            if batch.get(key) is not None:
                return batch[key].float()
            start, stop, total = global_rows(b)
            return torch.randn((total, latent_dim), generator=rng,
                               device=images.device)[start:stop]

        with exact_float32():
            # ---- the frozen-VGG pyramid of the real batch
            with span("step.pyramid.forward"), torch.no_grad():
                features_real = vgg(images)
            # ---- discriminator phase
            with span("step.d_phase.forward"):
                noise_d = noise("noise_d")
                with torch.no_grad():
                    fake_d = generator(noise_d, features_real, masks, labels)
                if fused_discriminator:
                    pred_real, pred_fake = discriminate_fused(
                        discriminator, images, fake_d, labels)
                else:
                    pred_real = discriminator(images, labels)
                    pred_fake = discriminator(fake_d, labels)
                loss_d_real, loss_d_fake = lsgan_discriminator_loss(
                    pred_real, pred_fake)
            with span("step.d_phase.backward"):
                state.d_optimizer.zero_grad(set_to_none=True)
                (loss_d_real + loss_d_fake).backward()
                all_reduce_gradients(discriminator)
            with span("step.d_phase.adam"):
                state.d_optimizer.step()
            # ---- generator phase (sees the updated discriminator)
            with (frozen(discriminator) if is_sharded(discriminator)
                  else contextlib.nullcontext()):
                with span("step.g_phase.forward"):
                    noise_g = noise("noise_g")
                    fake = generator(noise_g, features_real, masks, labels)
                    loss_g = lsgan_generator_loss(discriminator(fake, labels))
                    loss_div = w_div * diversity_loss(fake, noise_g)
                    features_fake = (checkpoint(vgg, fake, use_reentrant=False)
                                     if remat_vgg else vgg(fake))
                    loss_rec = w_rec * semantic_reconstruction_loss(
                        features_real, features_fake, masks)
                # G's gradients are summed while D is still frozen: the sum
                # reads G's gradients alone
                with span("step.g_phase.backward"):
                    state.g_optimizer.zero_grad(set_to_none=True)
                    backward_generator(loss_g + loss_div + loss_rec,
                                       generator)
                    all_reduce_gradients(generator)
            with span("step.g_phase.adam"):
                state.g_optimizer.step()
        state.step += 1
        metrics = {
            # the reference logger's names
            "loss_discriminator_real": loss_d_real,
            "loss_discriminator_fake": loss_d_fake,
            "loss_generator": loss_g,
            "loss_generator_semantic_reconstruction": loss_rec,
            "loss_generator_diversity": loss_div,
        }
        return state, sum_metrics({k: v.detach() for k, v in metrics.items()})

    return train_step


def make_generate_fn(generator: Generator, vgg: VGG16) -> Callable:
    """Eval-mode sampler: (images, masks, labels, noise) -> fakes.

    images (B, H, W, 3) float in [-1, 1] or uint8; masks the 7 shallow->deep
    levels, conv levels (B, h, w, 1); labels (B, num_classes) one-hot; noise
    (B, latent_dim). All NHWC as the JAX package's calling convention, on the
    models' device. Returns (B, H, W, 3) in the compute dtype. It runs
    under `torch.inference_mode`; sharded models (parallel/mesh.py) under
    `torch.no_grad`, as FSDP's gathered copies of their leaves must stay
    usable by later training forwards. Over sharded models every rank runs
    every generate (each forward gathers leaves from the other ranks)."""
    if generator.training or vgg.training:
        raise ValueError("make_generate_fn needs eval-mode models (.eval())")
    no_grad = (torch.no_grad if is_sharded(generator) or is_sharded(vgg)
               else torch.inference_mode)

    def generate(images: torch.Tensor, masks: Sequence[torch.Tensor],
                 labels: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        with no_grad(), exact_float32():
            return generate_nhwc(generator, vgg, images, masks, labels, noise)

    return generate


def generate_nhwc(generator: Generator, vgg: VGG16, images: torch.Tensor,
                  masks: Sequence[torch.Tensor], labels: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """The body of `make_generate_fn`'s sampler, with no grad mode or
    numerics of its own (the serving programs of serving/export.py trace
    it): the VGG pyramid of the images, then the Generator; NHWC in and
    out."""
    features = vgg(_nchw(ensure_m11_images(images)))
    fakes = generator(noise.float(), features, _float_masks(masks),
                      labels.float())
    return fakes.permute(0, 2, 3, 1)


class SPGANFamily:
    """The Semantic Pyramid GAN as the Trainer takes it (train/family.py):
    the reference `.pt` layout and the mask-level sweep grid; it refuses no
    option, and alone offers `generate` and `import_adam_moments`."""

    refusal, refuses = "", ()

    init_state = staticmethod(init_train_state)
    make_step = staticmethod(make_train_step)
    checkpoint = staticmethod(reference_gan_checkpoint)

    def hyperparameters(self, lr, w_rec, w_div) -> Dict[str, str]:
        return {"lr": str(lr), "w_rec": str(w_rec), "w_div": str(w_div)}

    def progress(self, fid: float, host: Dict[str, float]) -> str:
        return ("FID={:.4f}, Loss Div={:.4f}, Loss Rec={:.4f}, "
                "Loss G={:.4f}, Loss D={:.4f}".format(
                    fid, host["loss_generator_diversity"],
                    host["loss_generator_semantic_reconstruction"],
                    host["loss_generator"], host["loss_discriminator_real"]
                    + host["loss_discriminator_fake"]))

    def latent_dim(self, config) -> int:
        return config.latent_dim

    def sample(self, state: TrainState, batch: Batch,
               noise: torch.Tensor) -> torch.Tensor:
        """Eval-mode fakes (B, H, W, 3) of a device batch; G's mode is
        restored after."""
        training = state.generator.training
        state.generator.eval()
        try:
            return make_generate_fn(state.generator, state.vgg)(
                batch["images"], batch["masks"], batch["labels"], noise)
        finally:
            state.generator.train(training)

    generate = sample

    def grid(self, config, state: TrainState, images: np.ndarray,
             labels: np.ndarray, rng: torch.Generator, device: torch.device):
        """The mask-level sweep, a row per image, a column per pyramid level
        the conditioning is pinned at: ONE generate of levels * rows rows
        (tiled level-major), the latents drawn level by level."""
        n = images.shape[0]
        batch = batch_to_device({
            "images": np.tile(images, (GRID_LEVELS, 1, 1, 1)),
            "labels": np.tile(labels, (GRID_LEVELS, 1)),
            "masks": sweep_masks(MaskSchedule(config), n, GRID_LEVELS)},
            device)
        noise = torch.cat([
            torch.randn((n, config.latent_dim), generator=rng, device=device)
            for _ in range(GRID_LEVELS)])
        fakes = self.sample(state, batch, noise).float().cpu().numpy()
        return sweep_stack(fakes, n), GRID_LEVELS

    def restore(self, path: str, state: TrainState) -> TrainState:
        """A reference-layout `.pt` into `state` (restore_checkpoint)."""
        ckpt = load_reference_gan_checkpoint(path)
        if is_sharded(state.generator):
            check_replicated(file=tree_digest(ckpt))
        load_state_dict_(state.generator, ckpt["generator"])
        load_state_dict_(state.discriminator, ckpt["discriminator"])
        adam_step = self.import_adam_moments(state, ckpt)
        state.step = ckpt.get("step", adam_step or 0)
        return state

    def import_adam_moments(self, state: TrainState,
                            checkpoint: Mapping[str, Any]) -> Optional[int]:
        """Both nets' Adam moments of a loaded reference checkpoint, by
        parameter key; returns its Adam step count (None where empty)."""
        adam_step = None
        for net in ("generator", "discriminator"):
            adam_step = import_adam_moments(
                getattr(state, f"{net[0]}_optimizer"), getattr(state, net),
                checkpoint[f"{net}_optimizer"], checkpoint[net]) or adam_step
        return adam_step


SP_GAN = SPGANFamily()
