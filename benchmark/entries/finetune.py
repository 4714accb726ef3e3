"""The VGG-16 fine-tune step, driven as `cli/vgg16_finetune.py`'s
`FineTune.train_epoch` drives it: each step copies a host batch through the
CLI's `batch_to_device`, steps with `dropout_generator(epoch, step)`, keeps
the loss and top-1 sums on the device and fetches them every `fetch_every`
steps.

Set-up builds the model as the CLI does (`build_model`, then the benchmark's
weights loaded), its Adam and step, and runs the checked steps on the
pool's first batches; the check runs the reference's steps from the same
weights on the same batches with the dropout masks worked out again from
the CLI's seeding (`dropout_masks`).
"""

from __future__ import annotations

import contextlib
import io
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness, traffic as traffic_gen
from benchmark.entries import common
from benchmark.reference import gan as ref_gan
from benchmark.reference.common import exact_float32
from benchmark.reference.finetune import FineTuner
from benchmark.weights import make_weights

EPOCH = 0
DROPOUT_SEED = 1  # the CLI's dropout streams

# What the benchmark's tests and `control.py` read of this kind of work
# (README.md, "A new kind of work"): the test size, the float32 tolerance
# of each number its cells compare, whether its step opens the program's
# `sp:step` spans, its controls and their gaps; FAULTS and
# `control_readings` follow the reference below.
TEST_CONFIG = {"channels_factor": 8.0, "vgg_width_factor": 8,
               "num_classes": 16}
TEST_TRAFFIC = {"batch": 4, "pool": 3, "subwindow_units": [1, 1]}
# round-off between two float32 computations of the same arithmetic in
# another order: Adam's first steps move a near-zero gradient's leaf by
# about lr whatever its sign, so the change of the parameters is looser
FLOAT32_GAPS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2,
                "first_output_err": 1e-4}
OPENS_STEP_SPANS = True  # `cli/vgg16_finetune.py::make_finetune_step`
CONTROLS = common.TRAINING_CONTROLS
gaps = common.training_gaps


def dropout_masks(step: int, rows: int, features: int, device: torch.device):
    """The two keep masks the CLI's step `step` of epoch 0 draws: a generator
    seeded by SeedSequence((1, epoch, step)), fc6's mask first."""
    words = np.random.SeedSequence((DROPOUT_SEED, EPOCH, step)).generate_state(
        2, np.uint32)
    g = torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))
    return [torch.rand((rows, features), generator=g, device=device) < 0.5
            for _ in range(2)]


def to_device(batch, device: torch.device):
    images, labels = batch
    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    return x.permute(0, 3, 1, 2), torch.from_numpy(labels).to(device).long()


class Session:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool,
                 tamper=None):
        from semantic_pyramid_for_image_generation_torch.cli import (
            vgg16_finetune as cli,
        )

        self.cli, self.cell, self.device = cli, cell, device
        cfg, traffic = cell.config, cell.traffic
        self.batch = traffic["batch"]
        self.fetch_every = traffic["fetch_every"]
        self.subwindow_units = tuple(traffic["subwindow_units"])
        self.weights = make_weights(ref_gan.vgg_spec(ref_gan.Widths(cfg)),
                                    common.stream(seed, 20), device)
        self.batches = traffic_gen.finetune_batches(cfg, traffic, seed, device)
        with contextlib.redirect_stdout(io.StringIO()):
            self.model = cli.build_model(common.program_config(cfg), device,
                                         None)
        self.model.load_state_dict(self.weights, strict=True)
        self.optimizer = cli.make_optimizer(self.model, cfg["lr"])
        cli.set_epoch_lr(self.optimizer, cfg["lr"], EPOCH)
        self.train_step = cli.make_finetune_step(self.model, self.optimizer)
        if tamper is not None:
            tamper(self)
        self.sums = torch.zeros(2, device=device)
        self.count = 0
        self.steps = 0
        checked = []
        # the first step's logits: fc8's first call
        self.first_output = common.FirstOutput(
            self.model.vgg16.classifier[6])
        for i in range(traffic["checked_steps"]):
            checked.append(self._step())
            if i == 0:
                self.first_grads = {"vgg": common.norms(common.adam_first_grads(
                    self.optimizer, self.model))}
        self.change = {"vgg": common.norms(common.changes(
            dict(self.model.named_parameters()), self.weights))}
        self.checked_losses = [{"loss": v} for v in
                               torch.stack(checked).double().cpu().tolist()]

    def _step(self) -> torch.Tensor:
        images, labels = self.batches[self.steps % len(self.batches)]
        with torch.profiler.record_function("bench:finetune_step"):
            x, y = self.cli.batch_to_device(images, labels, self.device)
            loss, top1 = self.train_step(x, y, self.cli.dropout_generator(
                EPOCH, self.steps, self.device))
            self.sums += torch.stack([loss, top1]) * len(labels)
        self.count += len(labels)
        self.steps += 1
        if self.steps % self.fetch_every == 0:
            with torch.profiler.record_function("bench:fetch_metrics"):
                (self.sums / self.count).tolist()
        return loss

    def window(self, seconds: float) -> dict:
        start_steps = self.steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
        (self.sums / self.count).tolist()
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
        harness.sync(self.device)

    def step_flops(self) -> int:
        return reference_step_flops(self.cell.config, self.batch)

    def check(self) -> Dict[str, float]:
        program = {"losses": self.checked_losses, "grads": self.first_grads,
                   "change": self.change, "output": self.first_output.value}
        del self.model, self.optimizer, self.train_step
        harness.free()
        reference = reference_readings(self.cell.config, self.weights,
                                       self.batches,
                                       len(self.checked_losses), self.device)
        self.readings = {"program": program, "reference": reference}
        return common.training_gaps(program, reference)


def reference_readings(cfg: dict, weights: dict, batches: list, steps: int,
                       device: torch.device, precision: str = "float32",
                       batch_rows=None, lr=None) -> dict:
    """The reference's losses, first gradients and change over `steps`;
    `precision`, `batch_rows` and `lr` plant the control and the faults."""
    fc = ref_gan.Widths(cfg).fc7
    with exact_float32():
        tuner = FineTuner(cfg, weights, cfg["lr"] if lr is None else lr,
                          precision, batch_rows=batch_rows)
        losses = []
        for i in range(steps):
            x, y = to_device(batches[i], device)
            masks = dropout_masks(i, x.shape[0], fc, device)
            losses.append({"loss": tuner.run(x, y, masks)})
    return {"losses": losses, "output": tuner.first_output,
            "grads": {"vgg": common.norms(tuner.first_grads)},
            "change": {"vgg": common.norms(common.changes(tuner.params,
                                                          weights))}}


def reference_step_flops(cfg: dict, rows: int) -> int:
    """FLOPs of one reference fine-tune step at the cell's shapes, counted
    on the meta device by torch's FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    widths = ref_gan.Widths(cfg)
    weights = {k: torch.empty(shape, device=meta)
               for k, (shape, _) in ref_gan.vgg_spec(widths).items()}
    tuner = FineTuner(cfg, weights, cfg["lr"], remat=False)
    s = cfg["image_size"]
    x = torch.empty((rows, 3, s, s), device=meta)
    y = torch.zeros((rows,), dtype=torch.int64, device=meta)
    masks = [torch.ones((rows, widths.fc7), dtype=torch.bool, device=meta)] * 2
    counter = FlopCounterMode(display=False)
    with counter:
        tuner.step(x, y, masks)
    return counter.get_total_flops()


def _state_unchanged(session) -> None:
    """The step's updates dropped: Adam's step is a no-op."""
    common.drop_updates([session.optimizer])


def _half_batch(session) -> None:
    """Half of the batch left out: the forward runs on every row, and the
    cross-entropy is the mean over the first half's rows alone."""
    common.losses_on_half_batch(session, "train_step", torch.nn.functional,
                                ("cross_entropy",))


# the faults planted in the program by the tests, `tamper(session)` each
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}


def control_readings(session, control: str) -> dict:
    """The reference's readings under `control` (one of CONTROLS) from the
    session's weights and batches over its checked steps."""
    return reference_readings(
        session.cell.config, session.weights, session.batches,
        len(session.checked_losses), session.device,
        **common.training_control(control, session.batch))
