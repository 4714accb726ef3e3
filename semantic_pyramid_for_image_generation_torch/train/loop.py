"""Training orchestration on one device, counterpart of the JAX package's
train/loop.py::Trainer.

The same behaviour: metric names, the validation cadence on `samples_seen`,
per-epoch checkpoints, `epochs_trained` persisting across `train()` calls,
the initial validate + inference pass, and the 7x7 mask-level sweep grid as
one 49-row generate. On the card:
  * step metrics stay on the device and are fetched in one host copy every
    `log_every` steps (a per-step float() would wait for every step); every
    step is still logged;
  * each step draws its latents from a torch.Generator seeded by
    (seed + 1, state.step), so a resumed run draws what an uninterrupted one
    would;
  * validation and the grid run the generator in eval mode (no u/v or
    batch-norm statistics advance) and restore its mode after.
Checkpoints are the reference `.pt` layout (train/checkpoint.py).

Over several ranks (parallel/mesh.py; the JAX package's `is_lead` and
process-sharded data): every rank runs the same loop on its rows of each
batch and holds the same state (broadcast from rank 0 at construction);
`samples_seen` counts the global batch; only rank 0 creates the run
directories and writes metrics, grids and checkpoints, and every rank
waits for each checkpoint to be written; `auto_resume` restores on every
rank the file rank 0 picks. Validation walks each rank's rows and sums the
FID moments over the ranks; every rank runs the grid's generate, so the
eval generator advances alike on every rank. With `fsdp` > 1 the state is
sharded (parallel/mesh.py::shard_state): every generate is then a
collective, and a rank that gets no row of a ragged validation batch
generates a padded row it does not count (data/places365.py::shard_of);
each checkpoint is gathered whole on every rank and written by rank 0.

What differs between the models a Trainer trains is its family's
(train/family.py), looked up once from the config's type; the cadence,
the metric flush, the latents' seeding and the files are this module's.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import (
    DEFAULT_LR,
    DEFAULT_W_DIV,
    DEFAULT_W_REC,
)
from semantic_pyramid_for_image_generation_torch.eval.fid import FIDEvaluator
from semantic_pyramid_for_image_generation_torch.eval.grid import (
    save_inference_grid,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    broadcast_state,
    global_rows,
    make_mesh,
    rank,
    shard_state,
    world_size,
)
from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from semantic_pyramid_for_image_generation_torch.train.family import family_of
from semantic_pyramid_for_image_generation_torch.train.state import param_count
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.logger import (
    Logger,
    make_run_dirs,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import span


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The latent generator of train step `step`: seeded by (seed, step)."""
    with span("loop.rng"):
        words = np.random.SeedSequence((seed, step)).generate_state(
            2, np.uint32)
        return torch.Generator(device).manual_seed(
            int(words[0]) << 32 | int(words[1]))


class Trainer:
    def __init__(
        self,
        config: Any,
        training_dataset: Iterable[Dict[str, Any]],
        validation_dataset: Optional[Iterable[Dict[str, Any]]] = None,
        lr: float = DEFAULT_LR,
        w_rec: float = DEFAULT_W_REC,
        w_div: float = DEFAULT_W_DIV,
        save_data_path: str = "saved_data",
        device: torch.device | str = "cuda",
        tensorboard: bool = False,
        seed: int = 0,
        state: Optional[Any] = None,
        inception_state_dict: Optional[Mapping[str, Any]] = None,
        allow_random_fid: bool = False,
        fid_device_stats: bool = False,
        compat_inference_indices: bool = False,
        write_grids: bool = True,
        remat_vgg: bool = False,
        fused_discriminator: bool = False,
        fsdp: int = 1,
    ) -> None:
        """`config`'s type picks the family (train/family.py), which raises
        ValueError for the options it refuses (more than one rank counts as
        `multihost`). `state` defaults to the family's random init from
        `seed` on `device`.
        `write_grids=False` keeps each sweep grid as the array `last_grid`
        and writes no PNG (PIL is imported only to write one).
        `remat_vgg` and `fused_discriminator` are the train step's perf
        modes (train/step.py::make_train_step); `config.remat_blocks` is
        the third. `fsdp` > 1 shards the state over a (data, fsdp) mesh of
        the ranks (parallel/mesh.py::shard_state) once rank 0's is
        broadcast; it raises ValueError unless it divides the ranks. Pass
        an unsharded `state` whose optimizers hold nothing yet, and restore
        checkpoints after. `lr`, `w_rec` and `w_div` go to the family's
        init, step and logged hyperparameters."""
        self.device = resolve_device(device)
        self.config = config
        self.training_dataset = training_dataset
        self.validation_dataset = validation_dataset
        self.compat_inference_indices = compat_inference_indices
        self.write_grids = write_grids
        options = {"remat_vgg": remat_vgg,
                   "fused_discriminator": fused_discriminator}
        self.family = family_of(config, multihost=world_size() > 1,
                                fsdp=fsdp > 1, **options)
        self.state = state if state is not None else self.family.init_state(
            config, self.device, seed=seed, lr=lr)
        broadcast_state(self.state)
        self.mesh = None
        if fsdp > 1:
            self.mesh = make_mesh(fsdp, self.device.type)
            shard_state(self.state, self.mesh)
        self.is_lead = rank() == 0
        self.step_fn = self.family.make_step(w_rec=w_rec, w_div=w_div,
                                             **options)
        self.fid_evaluator = FIDEvaluator(
            inception_state_dict, self.device, allow_random=allow_random_fid,
            device_statistics=fid_device_stats)
        self.seed = seed
        self.rng = torch.Generator(self.device).manual_seed(seed + 1)
        self._inference_batch: Optional[Dict[str, Any]] = None
        self.last_grid: Optional[np.ndarray] = None
        self.paths = broadcast_object(
            make_run_dirs(save_data_path) if self.is_lead else None)
        self.logger = Logger(
            tensorboard_dir=os.path.join(self.paths["metrics"], "tensorboard")
            if tensorboard and self.is_lead else None)
        self.samples_seen = 0
        self.epochs_trained = 0  # persistent across train() calls
        self.logger.hyperparameter.update({
            "generator_params": str(param_count(self.state.generator)),
            "discriminator_params": str(param_count(self.state.discriminator)),
            "config": str(config),
            **self.family.hyperparameters(lr, w_rec, w_div),
        })

    # ------------------------------------------------------------------
    def _flush_metrics(self, pending) -> Optional[Dict[str, float]]:
        """ONE host copy for all buffered step metrics, logged in step order.
        Returns the newest step's host metrics (for the progress bar)."""
        if not pending:
            return None
        names = list(pending[0][0])
        with span("loop.fetch_metrics"):
            fetched = torch.stack([torch.stack([m[k] for k in names])
                                   for m, _, _ in pending]).cpu().tolist()
        host = None
        for values, (_, samples_seen, epoch) in zip(fetched, pending):
            host = dict(zip(names, values))
            for name, value in host.items():
                self.logger.log(name, value)
            self.logger.log("iterations", samples_seen)
            self.logger.log("epoch", epoch)
        pending.clear()
        return host

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One fused step on a numpy or device batch; the metrics stay on the
        device."""
        rng = step_generator(self.seed + 1, int(self.state.step), self.device)
        self.state, metrics = self.step_fn(
            self.state, batch_to_device(batch, self.device), rng)
        return metrics

    def train(
        self,
        epochs: int = 50,
        validate_after_n_iterations: int = 100_000,
        save_model_after_n_epochs: int = 1,
        validate_at_start: bool = True,
        progress: bool = True,
        log_every: int = 50,
    ) -> None:
        """The reference GAN loop around the fused step. Metrics are fetched
        in one host copy every `log_every` steps; log_every=1 syncs every
        step as the reference does."""
        if validate_at_start and self.validation_dataset is not None:
            self.inference()
            fid = self.validate()
        else:
            fid = float("nan")
        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(total=None, dynamic_ncols=True)
            except ImportError:
                bar = None
        next_validation = validate_after_n_iterations
        pending: list = []  # (device metrics, samples_seen, epoch) per step
        for _ in range(epochs):
            epoch = self.epochs_trained
            for batch in self.training_dataset:
                batch_size = batch["images"].shape[0] * world_size()
                metrics = self.train_step(batch)
                self.samples_seen += batch_size
                pending.append((metrics, self.samples_seen, epoch))
                if bar is not None:
                    bar.update(batch_size)
                host = None
                if len(pending) >= max(1, log_every):
                    host = self._flush_metrics(pending)
                if bar is not None and host is not None:
                    bar.set_description(self.family.progress(fid, host))
                if (self.validation_dataset is not None
                        and self.samples_seen >= next_validation):
                    next_validation += validate_after_n_iterations
                    self._flush_metrics(pending)
                    fid = self.validate()
                    self.inference()
                    self.logger.log("fid", fid)
                    self.logger.log("iterations_fid", self.samples_seen)
                    self._save_metrics()
            self._flush_metrics(pending)
            if epoch % save_model_after_n_epochs == 0:
                self.save_checkpoint(epoch)
            self.inference()
            self._save_metrics()
            self.epochs_trained += 1
        if bar is not None:
            bar.close()

    def _sp_gan_only(self, what: str):
        """The family's `what`, which only the SP-GAN's offers."""
        method = getattr(self.family, what, None)
        if method is None:
            raise ValueError(f"Trainer.{what} is the SP-GAN's; this model "
                             "samples through validate() and inference()")
        return method

    def _save_metrics(self) -> None:
        if self.is_lead:
            self.logger.save_metrics(self.paths["metrics"])

    def save_checkpoint(self, step: int) -> Optional[str]:
        """Rank 0 writes `checkpoint_<step>.pt` and returns its path (None on
        the other ranks); every rank takes part (a sharded state is
        gathered whole) and returns once it is written."""
        path = save_checkpoint(self.paths["models"], self.state, step=step,
                               write=self.is_lead)
        barrier()
        return path

    def import_adam_moments(self, checkpoint: Mapping[str, Any]) -> None:
        """Adopt the Adam moments of a loaded reference checkpoint
        (utils/pt_interop.py::load_reference_gan_checkpoint) without its
        weights, mapped by parameter key."""
        self._sp_gan_only("import_adam_moments")(self.state, checkpoint)

    def auto_resume(self, models_dir: Optional[str] = None) -> bool:
        """Restore the newest checkpoint under `models_dir` (default: this
        run's models dir) if there is one. Over several ranks, rank 0 picks
        the file and every rank restores it."""
        path = broadcast_object(latest_checkpoint(
            models_dir or self.paths["models"]) if self.is_lead else None)
        if path is None:
            return False
        restore_checkpoint(path, self.state)
        print(f"auto-resumed from {path} (step {int(self.state.step)})")
        return True

    def profile_steps(self, batch: Mapping[str, Any], log_dir: str,
                      steps: int = 3) -> None:
        """A torch.profiler chrome trace of `steps` train steps under
        `log_dir` (utils/profiling.py). The trace carries the phase spans
        (`sp:loop.rng`, `sp:loop.to_device`, `sp:step` and the phases in
        it; utils/profiling.py::span)."""
        from semantic_pyramid_for_image_generation_torch.utils.profiling import (
            trace,
        )

        with trace(log_dir):
            for _ in range(steps):
                metrics = self.train_step(batch)
            metrics["loss_generator"].cpu()

    # ------------------------------------------------------------------
    def _latents(self, rng: torch.Generator, n: int,
                 rows: Optional[Any] = None) -> torch.Tensor:
        """This rank's rows of the latents drawn from `rng` for its global
        batch (`global_rows`): n ranks draw what one rank draws."""
        start, stop, total = global_rows(n, rows)
        return torch.randn((total, self.family.latent_dim(self.config)),
                           generator=rng, device=self.device)[start:stop]

    def generate(self, batch: Mapping[str, Any],
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eval-mode fakes (B, H, W, 3) for a device batch; the latents are
        drawn from the Trainer's eval generator unless given."""
        generate = self._sp_gan_only("generate")
        if noise is None:
            noise = self._latents(self.rng, batch["images"].shape[0])
        return generate(self.state, batch, noise)

    def validate(self) -> float:
        """FID of the family's fresh fakes against the validation set, batch
        by batch.
        One draw from the eval generator seeds this validation's latents (as
        the JAX package splits its key once per validation), so every rank
        draws the same latents whatever rows it holds, and a rank that gets
        no rows of a ragged last batch stays in step."""
        assert self.validation_dataset is not None
        seed = torch.randint(2 ** 62, (1,), generator=self.rng,
                             device=self.device)
        rng = torch.Generator(self.device).manual_seed(int(seed))

        def batches():
            for b in self.validation_dataset:
                batch = batch_to_device(b, self.device)
                batch["noise"] = self._latents(
                    rng, batch["images"].shape[0], b.get("shard_rows"))
                yield batch

        return self.fid_evaluator.fid(batches(), lambda batch: (
            self.family.sample(self.state, batch, batch["noise"])))

    def _draw_inference_samples(self, num_images: int):
        """Seeded random draw of `num_images` distinct validation samples,
        seeded by (seed, samples_seen) so grids vary across training yet
        reruns reproduce them. Plain-iterable validation sets give their
        first batch's rows instead."""
        ds = getattr(self.validation_dataset, "dataset", None)
        if ds is not None and hasattr(ds, "sample") and len(ds) > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool_n = len(ds)
            if self.compat_inference_indices:
                # reference quirk: indices drawn from range(len(dataloader)),
                # the BATCH COUNT, so only the first n_batches items appear
                bs = getattr(self.validation_dataset, "batch_size", None)
                if bs:
                    drop = getattr(self.validation_dataset, "drop_last", False)
                    nb = len(ds) // bs if drop else -(-len(ds) // bs)
                    pool_n = max(1, min(pool_n, nb))
            pick = np.random.default_rng((self.seed, self.samples_seen))
            idx = pick.choice(pool_n, size=min(num_images, pool_n),
                              replace=False)
            with ThreadPoolExecutor(len(idx)) as pool:  # parallel decode
                samples = list(pool.map(
                    lambda i: ds.sample(
                        int(i), np.random.default_rng((self.seed, int(i)))),
                    idx))
            return (np.stack([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]))
        if self._inference_batch is None:
            self._inference_batch = next(iter(self.validation_dataset))
        batch = self._inference_batch
        return (np.asarray(batch["images"][:num_images]),
                np.asarray(batch["labels"][:num_images]))

    def inference(self, num_images: int = 7) -> Optional[str]:
        """The family's grid (the SP-GAN's 7x7 mask-level sweep) of
        `num_images` validation samples, repeated where there are fewer, on
        latents from the eval generator. The grid stays in `last_grid`; the
        PNG path is returned (None with write_grids=False, and on every
        rank but rank 0, which alone writes it)."""
        if self.validation_dataset is None:
            return None
        images, labels = (np.resize(a, (num_images,) + a.shape[1:])
                          for a in self._draw_inference_samples(num_images))
        self.last_grid, nrow = self.family.grid(
            self.config, self.state, images, labels, self.rng, self.device)
        if not (self.write_grids and self.is_lead):
            return None
        path = os.path.join(self.paths["plots"],
                            f"predictions_{self.samples_seen}.png")
        save_inference_grid(self.last_grid, path, nrow=nrow)
        return path
