"""BigGAN-deep's train step (two D updates, one G update, G's EMA), driven
as the program's Trainer drives it.

Set-up builds the BigGAN-deep state on the benchmark's weights and hands it
to a `train/loop.py::Trainer`, then runs the checked steps through
`Trainer.train_step` on the first batches of the pool: after each
network's first update it reads each parameter's gradient from the Adam
moments (with the optimizer's own beta1), after the last step the change of
G's and D's parameters and of G_ema's state. D's first update is read, not
its last of the step: at these widths D's scores reach hundreds, so after
one update its hinge loss may take no row, and the second update's gradient
is then all zeros. The window runs the same call on the pool's batches in
turn, fetching the step metrics in one host copy every `fetch_every` steps,
as `Trainer.train` does at its `log_every`.

The check frees the program and runs the reference's steps from the same
weights on the same batches and draws (the Trainer's latents and fake
classes worked out again from its seeding, `draws`).
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from benchmark import harness
from benchmark.entries import common
from benchmark.reference import biggan_deep as ref
from benchmark.reference.common import exact_float32
from benchmark.weights import POWER_ITERATIONS, make_weights

METRIC_NAMES = ref.LOSS_NAMES

# What the benchmark's tests and `control.py` read of this kind of work
# (README.md, "A new kind of work"): the test size, the float32 tolerance
# of each number its cells compare, whether its step opens the program's
# `sp:step` spans, its controls and their gaps; FAULTS and
# `control_readings` follow the reference below.
TEST_CONFIG = {"resolution": 64, "ch": 8, "attention_resolution": 32,
               "num_classes": 16, "dim_z": 16, "shared_dim": 16}
TEST_TRAFFIC = {"batch": 4, "pool": 3, "subwindow_units": [1, 1]}
# round-off between two float32 computations of the same arithmetic in
# another order, where the program's channels_last batch norms sum in
# another order on the CPU; Adam with beta1 = 0 moves a near-zero
# gradient's element by about lr whatever its sign, so the change of the
# parameters, and G_ema's with it, is looser; the update counts are exact
FLOAT32_GAPS = {"loss_gap": 1e-3, "grad_p90_gap": 1e-3, "change_gap": 5e-2,
                "first_output_err": 1e-4, "ema_gap": 5e-2, "update_gap": 0.0}
OPENS_STEP_SPANS = True  # `train/biggan_deep.py::make_train_step`'s spans
CONTROLS = common.TRAINING_CONTROLS
PROGRAM_KEYS = ("resolution", "ch", "depth", "bottleneck_ratio", "dim_z",
                "shared_dim", "num_classes", "attention_resolution",
                "num_d_steps", "g_lr", "d_lr", "adam_eps",
                "bn_eps", "bn_momentum", "sn_eps", "ema_decay", "ema_start",
                "attention_gamma", "compute_dtype")


def program_config(cfg: dict):
    """The program's BigGANDeepConfig for a configuration file."""
    from semantic_pyramid_for_image_generation_torch.config import (
        BigGANDeepConfig,
    )

    return BigGANDeepConfig(adam_betas=tuple(cfg["adam_betas"]),
                            **{k: cfg[k] for k in PROGRAM_KEYS})


@torch.no_grad()
def weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, dict]:
    """G's and D's state dicts from the seed: each weight that
    BigGAN-PyTorch draws with `init.orthogonal_` drawn the same way (the Q
    of a normal draw's QR, signed by R's diagonal), biases zero, batch-norm
    statistics at (0, 1), the attention's gamma at the configuration's, and
    each spectral layer's u, v after POWER_ITERATIONS power iterations."""
    widths = ref.Widths(cfg)
    out = {}
    for i, (net, spec) in enumerate((("generator", ref.generator_spec),
                                     ("discriminator",
                                      ref.discriminator_spec))):
        spec = spec(widths)
        drawn = {k: (shape, {"orthogonal": "normal", "gamma": "ones"}.get(
            kind, kind)) for k, (shape, kind) in spec.items()}
        w = make_weights(drawn, common.stream(seed, 40 + i), device)
        for key, (shape, kind) in spec.items():
            if kind == "orthogonal":
                w[key] = _orthogonal(w[key])
            elif kind == "gamma":
                w[key] = w[key] * cfg["attention_gamma"]
        _converge(w)
        out[net] = w
    return out


def _orthogonal(draw: torch.Tensor) -> torch.Tensor:
    flat = draw.reshape(draw.shape[0], -1)
    wide = flat.shape[0] < flat.shape[1]
    q, r = torch.linalg.qr(flat.T if wide else flat)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if wide else q).reshape(draw.shape).contiguous()


def _converge(w: dict) -> None:
    for key in [k for k in w if k.endswith(".weight_orig")]:
        name = key[:-len(".weight_orig")]
        m = w[key].reshape(w[key].shape[0], -1)
        u, v = w[f"{name}.weight_u"], w[f"{name}.weight_v"]
        for _ in range(POWER_ITERATIONS):
            v = m.T @ u
            v = v / v.norm().clamp(min=1e-12)
            u = m @ v
            u = u / u.norm().clamp(min=1e-12)
        w[f"{name}.weight_u"], w[f"{name}.weight_v"] = u, v


def host_batches(cfg: dict, traffic: dict, seed: int,
                 device: torch.device) -> List[dict]:
    """`pool` host batches of `num_d_steps * batch` real rows: uint8
    (B, R, R, 3) images, every row different, and int64 labels uniform over
    the classes, drawn on the device in two calls."""
    g = torch.Generator(device).manual_seed(common.stream(seed, 41))
    pool, s = traffic["pool"], cfg["resolution"]
    rows = traffic["batch"] * cfg["num_d_steps"]
    images = torch.randint(0, 256, (pool, rows, s, s, 3), dtype=torch.uint8,
                           generator=g, device=device).cpu().numpy()
    labels = torch.randint(0, cfg["num_classes"], (pool, rows), generator=g,
                           device=device).cpu().numpy()
    return [{"images": images[i], "labels": labels[i]} for i in range(pool)]


def draws(seed: int, step: int, rows: int, cfg: dict, updates: int,
          device: torch.device) -> list:
    """The (z, y) of each D update and then of the G update of the
    Trainer's step `step`: a generator seeded by SeedSequence((seed,
    step)), z then y for each."""
    words = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    g = torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))
    out = []
    for _ in range(updates + 1):
        z = torch.randn((rows, cfg["dim_z"]), generator=g, device=device)
        y = torch.randint(0, cfg["num_classes"], (rows,), generator=g,
                          device=device)
        out.append((z, y))
    return out


def first_grads(optimizer: torch.optim.Optimizer, module) -> Dict[str, float]:
    """The norm of each parameter's gradient of the optimizer's first step,
    as it got it: its first moment over (1 - beta1), beta1 its own."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in module.named_parameters():
        slot = optimizer.state.get(p)
        if slot and "exp_avg" in slot:
            out[name] = slot["exp_avg"].detach().float() / (1.0 - beta1)
    return common.norms(out)


def adam_steps(optimizer: torch.optim.Optimizer) -> int:
    """The updates an Adam took: its per-parameter step count (0 before
    its first step)."""
    return max((int(slot["step"]) for slot in optimizer.state.values()
                if "step" in slot), default=0)


def ema_change(ema: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """The norm of G_ema's change from G's start, per floating entry."""
    return common.norms({k: v.detach().float() - start[k]
                         for k, v in ema.items() if v.is_floating_point()})


def gaps(program: dict, reference: dict) -> Dict[str, float]:
    """`common.training_gaps`, with the losses and G_ema's change read as
    follows.

    `loss_gap` / `first_loss_gap`: each loss's gap over max(|reference|,
    1). The hinge losses reach 0 and -E[D(G(z))] changes sign, so a gap
    relative to the loss alone measures nothing near 0; their scale is the
    hinge's margin, 1.

    `ema_gap`: G_ema's change over the checked steps against the
    reference's, by the worst leaf (`common.leaf_gaps`) of G's parameters
    that `change_gap` reads (reference gradient at least CHANGE_LEAF_FLOOR
    of the median's: the biases a batch norm follows have none, and Adam
    moves them by round-off's sign) and of the running statistics. The
    spectral u and v are left out: every singular value of an orthogonal
    weight is 1, so which vectors the power iteration finds after a step
    is round-off's choice (sigma, which the forward uses, is not).

    `update_gap`: the D and G updates the checked steps took, as each Adam
    counts them, against the reference's, by the relative gap of the worse
    network: `num_d_steps` D updates per G update."""
    out = common.training_gaps(program, reference)

    def loss_gaps(steps):
        found = [abs(p[name] - r) / max(abs(r), 1.0)
                 if math.isfinite(p[name]) else math.inf
                 for p, rs in steps for name, r in rs.items()]
        return max(found) if found else math.inf

    pairs = list(zip(program["losses"], reference["losses"]))
    out["loss_gap"] = (loss_gaps(pairs) if len(program["losses"])
                       == len(reference["losses"]) else math.inf)
    out["first_loss_gap"] = loss_gaps(pairs[:1])
    grads = reference["grads"]["generator"]
    median = statistics.median(grads.values())
    leaves = [k for k, g in grads.items()
              if g >= common.CHANGE_LEAF_FLOOR * median]
    leaves += [k for k in reference["ema"]
               if k.endswith((".running_mean", ".running_var"))]
    out["ema_gap"] = max(common.leaf_gaps(program["ema"], reference["ema"],
                                          leaves))
    out["update_gap"] = max(abs(program["updates"][net] - n) / n
                            for net, n in reference["updates"].items())
    return out


class Session:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool,
                 tamper=None):
        from semantic_pyramid_for_image_generation_torch.models import (
            biggan_deep as nets,
        )
        from semantic_pyramid_for_image_generation_torch.train import (
            biggan_deep as program,
        )
        from semantic_pyramid_for_image_generation_torch.train.loop import (
            Trainer,
        )

        self.cell, self.device = cell, device
        cfg, traffic = cell.config, cell.traffic
        self.rows = traffic["batch"]  # per D update and per G update
        self.batch = self.rows * cfg["num_d_steps"]  # real images a step
        self.fetch_every = traffic["fetch_every"]
        self.subwindow_units = tuple(traffic["subwindow_units"])
        self.trainer_seed = common.stream(seed, 1) % 2 ** 31
        self.weights = weights(cfg, seed, device)
        self.batches = host_batches(cfg, traffic, seed, device)
        pcfg = program_config(cfg)
        with torch.device(device):
            generator = nets.BigGANDeepGenerator(pcfg)
            discriminator = nets.BigGANDeepDiscriminator(pcfg)
            generator_ema = nets.BigGANDeepGenerator(pcfg)
        for module, net in ((generator, "generator"),
                            (discriminator, "discriminator"),
                            (generator_ema, "generator")):
            module.load_state_dict(self.weights[net], strict=True)
            module.to(memory_format=torch.channels_last).train()
        generator_ema.requires_grad_(False).eval()
        state = program.BigGANDeepState(
            generator, discriminator, generator_ema,
            *program.make_optimizers(generator, discriminator))
        self.run_dir = tempfile.mkdtemp(prefix="bench_biggan_")
        self.trainer = Trainer(
            pcfg, training_dataset=[], save_data_path=self.run_dir,
            device=device, seed=self.trainer_seed, allow_random_fid=True,
            write_grids=False, state=state)
        if tamper is not None:
            tamper(self)
        self.pending: List[tuple] = []
        self.steps = 0
        self.checked_losses = []
        state = self.trainer.state
        # the first D update's fakes: G's first call
        self.first_output = common.FirstOutput(state.generator)
        self.first_grads = {}
        for net, optimizer in (("generator", state.g_optimizer),
                               ("discriminator", state.d_optimizer)):
            self._read_first_update(net, optimizer, getattr(state, net))
        for i in range(traffic["checked_steps"]):
            self.checked_losses.append(self.trainer.train_step(
                self.batches[i]))
            self.steps += 1
        self.change = {net: common.norms(common.changes(
            dict(module.named_parameters()), self.weights[net]))
            for net, module in (("generator", state.generator),
                                ("discriminator", state.discriminator))}
        self.updates = {"generator": adam_steps(state.g_optimizer),
                        "discriminator": adam_steps(state.d_optimizer)}
        self.ema = ema_change(state.generator_ema.state_dict(),
                              self.weights["generator"])
        self.checked_losses = [
            dict(zip(METRIC_NAMES, torch.stack(
                [m[k] for k in METRIC_NAMES]).double().cpu().tolist()))
            for m in self.checked_losses]

    def _read_first_update(self, net: str, optimizer, module) -> None:
        """Reads `optimizer`'s first step's gradients (`first_grads`) right
        after it, then takes itself out."""
        inner = optimizer.step

        def step(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.first_grads[net] = first_grads(optimizer, module)
            optimizer.step = inner
            return out

        optimizer.step = step

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
        return reference_step_flops(self.cell.config, self.rows)

    def check(self) -> Dict[str, float]:
        program = {"losses": self.checked_losses, "grads": self.first_grads,
                   "change": self.change, "output": self.first_output.value,
                   "ema": self.ema, "updates": self.updates}
        del self.trainer
        shutil.rmtree(self.run_dir, ignore_errors=True)
        harness.free()
        reference = reference_readings(
            self.cell.config, self.weights, self.batches,
            len(self.checked_losses), self.trainer_seed, self.rows,
            self.device)
        self.readings = {"program": program, "reference": reference}
        return gaps(program, reference)


def reference_readings(cfg: dict, weights: dict, batches: list, steps: int,
                       trainer_seed: int, rows: int, device: torch.device,
                       precision: str = "float32", batch_rows=None,
                       lr=None) -> dict:
    """The reference's losses, first gradients, change and G_ema's change
    over `steps` steps from `weights` on the pool's first batches;
    `precision`, `batch_rows` and `lr` plant the control and the faults."""
    updates = cfg["num_d_steps"]
    with exact_float32():
        trainer = ref.BigGANDeepTrainer(
            cfg, weights["generator"], weights["discriminator"], precision,
            remat=True, batch_rows=batch_rows, lr=lr)
        losses = []
        for i in range(steps):
            put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
            losses.append(trainer.run(
                put(batches[i]["images"]), put(batches[i]["labels"]),
                draws(trainer_seed + 1, i, rows, cfg, updates, device)))
    grads = {net: common.norms(g) for net, g in trainer.first_grads.items()}
    change = {"generator": common.norms(common.changes(
        trainer.g, weights["generator"])),
        "discriminator": common.norms(common.changes(
            trainer.d, weights["discriminator"]))}
    return {"losses": losses, "grads": grads, "change": change,
            "output": trainer.first_output,
            "ema": ema_change(trainer.ema, weights["generator"]),
            "updates": {"generator": trainer.steps,
                        "discriminator": trainer.d_updates}}


def reference_step_flops(cfg: dict, rows: int) -> int:
    """FLOPs of one reference step at the cell's shapes (`rows` per update),
    counted on the meta device by torch's FlopCounterMode: the model's work,
    whatever the program launches."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    widths = ref.Widths(cfg)
    nets = {net: {k: (torch.zeros(shape, dtype=torch.int64, device=meta)
                      if kind == "count" else torch.empty(shape, device=meta))
                  for k, (shape, kind) in spec(widths).items()}
            for net, spec in (("generator", ref.generator_spec),
                              ("discriminator", ref.discriminator_spec))}
    updates, s = cfg["num_d_steps"], cfg["resolution"]
    trainer = ref.BigGANDeepTrainer(cfg, nets["generator"],
                                    nets["discriminator"], remat=False)
    images = torch.zeros((rows * updates, s, s, 3), dtype=torch.uint8,
                         device=meta)
    labels = torch.zeros((rows * updates,), dtype=torch.int64, device=meta)
    draw = (torch.zeros((rows, cfg["dim_z"]), device=meta),
            torch.zeros((rows,), dtype=torch.int64, device=meta))
    counter = FlopCounterMode(display=False)
    with counter:
        trainer.step(images, labels, [draw] * (updates + 1))
    return counter.get_total_flops()


def _during_step(session, patch) -> None:
    """Plants `patch` (a context manager) around each of the Trainer's
    steps."""
    inner = session.trainer.step_fn

    def step(*args, **kwargs):
        with patch():
            return inner(*args, **kwargs)

    session.trainer.step_fn = step


def _state_unchanged(session) -> None:
    """The step's updates dropped: both Adams' steps are no-ops."""
    state = session.trainer.state
    common.drop_updates([state.g_optimizer, state.d_optimizer])


def _half_batch(session) -> None:
    """Half of the rows left out: the forwards run on every row, and each
    hinge loss is the mean over the first half of its rows alone."""
    from semantic_pyramid_for_image_generation_torch.train import biggan_deep

    common.losses_on_half_batch(
        session.trainer, "step_fn", biggan_deep,
        ("hinge_discriminator_loss", "hinge_generator_loss"))


def _ema_skipped(session) -> None:
    """G's EMA left out: the step's `update_ema` a no-op."""
    from semantic_pyramid_for_image_generation_torch.train import biggan_deep

    _during_step(session, lambda: mock.patch.object(
        biggan_deep, "update_ema", lambda *args: None))


def _single_d_step(session) -> None:
    """One D update per G update: every second D update's Adam step is
    dropped, so D steps once on the first chunk's gradients."""
    optimizer = session.trainer.state.d_optimizer
    inner, calls = optimizer.step, [0]

    def step(*args, **kwargs):
        calls[0] += 1
        if calls[0] % 2:
            return inner(*args, **kwargs)
        return None

    optimizer.step = step


# the faults planted in the program by the tests, `tamper(session)` each
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "ema_skipped": _ema_skipped, "single_d_step": _single_d_step}


def control_readings(session, control: str) -> dict:
    """The reference's readings under `control` (one of CONTROLS) from the
    session's weights, batches and draws over its checked steps."""
    return reference_readings(
        session.cell.config, session.weights, session.batches,
        len(session.checked_losses), session.trainer_seed, session.rows,
        session.device, **common.training_control(control, session.rows))

