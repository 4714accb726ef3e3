"""The GAN's fused G/D train step, driven as the program's Trainer drives it.

Set-up builds the TrainState on the benchmark's weights and hands it to a
`train/loop.py::Trainer` (the CLI's loop), then runs the checked steps
through `Trainer.train_step` on the first batches of the pool: after the
first it reads each parameter's first gradient from the Adam moments, after
the last the parameters' change, before any later step moves them. The
window runs the same call on the pool's batches in turn, fetching the step
metrics in one host copy every `fetch_every` steps, as `Trainer.train`
does at its `log_every`.

The check frees the program and runs the reference's step from the same
weights on the same batches and latents (the Trainer's latents worked out
again from its seeding, `latents`).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic as traffic_gen
from benchmark.entries import common
from benchmark.reference import gan as ref_gan
from benchmark.reference.common import exact_float32

METRIC_NAMES = ref_gan.LOSS_NAMES


def latents(seed: int, step: int, rows: int, latent_dim: int,
            device: torch.device):
    """(noise_d, noise_g) of the Trainer's step `step`: a generator seeded by
    SeedSequence((seed, step)), D's latents drawn first."""
    words = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    g = torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))
    noise_d = torch.randn((rows, latent_dim), generator=g, device=device)
    noise_g = torch.randn((rows, latent_dim), generator=g, device=device)
    return noise_d, noise_g


def to_device(batch: dict, device: torch.device) -> dict:
    put = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
    return {"images": put(batch["images"]), "labels": put(batch["labels"]),
            "masks": tuple(put(m) for m in batch["masks"])}


class Session:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool,
                 tamper=None):
        from semantic_pyramid_for_image_generation_torch.models import (
            make_discriminator,
            make_models,
        )
        from semantic_pyramid_for_image_generation_torch.train.loop import (
            Trainer,
        )
        from semantic_pyramid_for_image_generation_torch.train.state import (
            TrainState,
            make_optimizers,
        )

        self.cell, self.device = cell, device
        cfg, traffic = cell.config, cell.traffic
        self.batch = traffic["batch"]
        self.fetch_every = traffic["fetch_every"]
        self.subwindow_units = tuple(traffic["subwindow_units"])
        self.trainer_seed = common.stream(seed, 1) % 2 ** 31
        self.weights = common.gan_weights(cfg, seed, device)
        self.batches = traffic_gen.gan_batches(cfg, traffic, seed, device)
        pcfg = common.program_config(cfg)
        generator, vgg = make_models(pcfg, device)
        discriminator = make_discriminator(pcfg, device)
        for module, net in ((generator, "generator"),
                            (discriminator, "discriminator"), (vgg, "vgg")):
            module.load_state_dict(self.weights[net], strict=True)
        vgg.requires_grad_(False)
        generator.train()
        discriminator.train()
        g_opt, d_opt = make_optimizers(generator, discriminator, cfg["lr"])
        self.run_dir = tempfile.mkdtemp(prefix="bench_gan_")
        self.trainer = Trainer(
            pcfg, training_dataset=[], lr=cfg["lr"], w_rec=cfg["w_rec"],
            w_div=cfg["w_div"], save_data_path=self.run_dir, device=device,
            seed=self.trainer_seed, allow_random_fid=True, write_grids=False,
            state=TrainState(generator, discriminator, vgg, g_opt, d_opt))
        if tamper is not None:
            tamper(self)
        self.pending: List[tuple] = []
        self.steps = 0
        self.checked_losses = []
        state = self.trainer.state
        # the D phase's fakes of the first step: G's first call
        self.first_output = common.FirstOutput(state.generator)
        for i in range(traffic["checked_steps"]):
            self.checked_losses.append(self.trainer.train_step(
                self.batches[i]))
            self.steps += 1
            if i == 0:
                self.first_grads = {
                    net: common.adam_first_grads(opt, module)
                    for net, opt, module in (
                        ("generator", state.g_optimizer, state.generator),
                        ("discriminator", state.d_optimizer,
                         state.discriminator))}
                self.first_grads = {net: common.norms(g) for net, g in
                                    self.first_grads.items()}
        self.change = {net: common.norms(common.changes(
            dict(module.named_parameters()), self.weights[net]))
            for net, module in (("generator", state.generator),
                                ("discriminator", state.discriminator))}
        self.checked_losses = [
            dict(zip(METRIC_NAMES, torch.stack(
                [m[k] for k in METRIC_NAMES]).double().cpu().tolist()))
            for m in self.checked_losses]

    def _step(self) -> None:
        with torch.profiler.record_function("bench:train_step"):
            metrics = self.trainer.train_step(
                self.batches[self.steps % len(self.batches)])
        self.steps += 1
        self.pending.append((metrics, self.steps * self.batch, 0))
        if len(self.pending) >= self.fetch_every:
            with torch.profiler.record_function("bench:fetch_metrics"):
                self.trainer._flush_metrics(self.pending)

    def window(self, seconds: float) -> dict:
        start_steps = self.steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
        self.trainer._flush_metrics(self.pending)
        harness.sync(self.device)
        elapsed = time.perf_counter() - t0
        steps = self.steps - start_steps
        return {"train_images_per_s": steps * self.batch / elapsed,
                "steps": steps, "seconds": elapsed,
                "attempted": steps, "failed": 0}

    def subwindow(self, units: int) -> None:
        for _ in range(units):
            self._step()

    def finish(self) -> None:
        self.trainer._flush_metrics(self.pending)
        harness.sync(self.device)

    def step_flops(self) -> int:
        return reference_step_flops(self.cell.config, self.batch)

    def check(self) -> Dict[str, float]:
        program = {"losses": self.checked_losses, "grads": self.first_grads,
                   "change": self.change, "output": self.first_output.value}
        del self.trainer
        shutil.rmtree(self.run_dir, ignore_errors=True)
        harness.free()
        reference = reference_readings(
            self.cell.config, self.weights, self.batches,
            len(self.checked_losses), self.trainer_seed, self.device)
        self.readings = {"program": program, "reference": reference}
        return common.training_gaps(program, reference)


def reference_readings(cfg: dict, weights: dict, batches: list, steps: int,
                       trainer_seed: int, device: torch.device,
                       precision: str = "float32",
                       batch_rows=None, lr=None) -> dict:
    """The reference's losses, first gradients and change over `steps`
    steps from `weights` on the pool's first batches; `precision`,
    `batch_rows` and `lr` plant the control and the faults."""
    with exact_float32():
        trainer = ref_gan.GANTrainer(
            cfg, weights["generator"], weights["discriminator"],
            weights["vgg"], cfg["lr"] if lr is None else lr, cfg["w_rec"],
            cfg["w_div"], precision,
            remat=True, batch_rows=batch_rows)
        losses = []
        for i in range(steps):
            rows = batches[i]["images"].shape[0]
            noise_d, noise_g = latents(trainer_seed + 1, i, rows,
                                       cfg.get("latent_dim", 128), device)
            losses.append(trainer.run(to_device(batches[i], device),
                                      noise_d, noise_g))
    grads = {net: common.norms(g) for net, g in trainer.first_grads.items()}
    change = {"generator": common.norms(common.changes(
        trainer.g, weights["generator"])),
        "discriminator": common.norms(common.changes(
            trainer.d, weights["discriminator"]))}
    return {"losses": losses, "grads": grads, "change": change,
            "output": trainer.first_output}


def reference_step_flops(cfg: dict, rows: int) -> int:
    """FLOPs of one reference step at the cell's shapes, counted on the meta
    device by torch's FlopCounterMode: the model's work, whatever the
    program launches."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    widths = ref_gan.Widths(cfg)
    weights = {net: {k: (torch.zeros(shape, dtype=torch.int64, device=meta)
                         if kind == "count" else
                         torch.empty(shape, device=meta))
                     for k, (shape, kind) in spec(widths).items()}
               for net, spec in (("generator", ref_gan.generator_spec),
                                 ("discriminator", ref_gan.discriminator_spec),
                                 ("vgg", ref_gan.vgg_spec))}
    s = cfg["image_size"]
    batch = {"images": torch.zeros((rows, s, s, 3), dtype=torch.uint8,
                                   device=meta),
             "labels": torch.zeros((rows, cfg["num_classes"]), device=meta),
             "masks": tuple(torch.zeros((rows,) + shape, device=meta)
                            for shape in traffic_gen.pyramid_shapes(cfg))}
    trainer = ref_gan.GANTrainer(cfg, weights["generator"],
                                 weights["discriminator"], weights["vgg"],
                                 cfg["lr"], cfg["w_rec"], cfg["w_div"],
                                 remat=False)
    noise = torch.zeros((rows, cfg.get("latent_dim", 128)), device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        trainer.step(batch, noise, noise)
    return counter.get_total_flops()
