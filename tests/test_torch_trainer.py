"""The port's Trainer and training CLI against the JAX package's.

  * Trainer vs JAX: the port's `Trainer` and the JAX package's
    `Trainer(use_mesh=False)` from one state (the port's seeded init, u/v
    advanced 10 iterations, carried across by the JAX package's converters),
    at tiny() in fp32, on 2 batches with pinned latents (`noise_d` /
    `noise_g`): every logged metric within rtol 2e-3 / atol 2e-5 and the
    parameters after both steps under tests/test_torch_train_step.py's rule
    (1e-2 * lr plus one fp32 ulp on all of D's elements and all but 0.1% of
    G's, every element within 4 * lr).
  * Trainer behaviour: artifact layout, checkpoint cadence, checkpoint
    numbering that continues across train() calls, no dropped metrics when
    they are fetched every `log_every` > 1 steps, noise that a resume draws
    as an uninterrupted run would, and the 49-row sweep grid equal to seven
    looped 7-row generates with the same latents (1e-5 absolute in fp32:
    the same per-sample arithmetic at another batch size).
  * the family seam (train/family.py): a stub family handed to the one
    lookup trains an epoch, writes its grid and a checkpoint, and resumes
    through the Trainer and train/checkpoint.py as they stand;
  * CLI: the parser's dests and defaults are the JAX package's but for
    `--device` and the port's `--arch` / `--image_folder`; `--fsdp` raises without `--multihost` and when it does not
    divide the ranks (`--multihost` runs: tests/test_torch_cli.py, with
    `--fsdp`: tests/test_torch_fsdp_cli.py); `main` trains,
    validates, writes metrics, `checkpoint_000.pt` and a grid PNG on a mini
    Places365 tree, and resumes from the checkpoint.
"""

import dataclasses
import glob
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_pyramid_for_image_generation_tpu.cli.main import (
    build_parser as jax_build_parser,
)
from semantic_pyramid_for_image_generation_tpu.models.inception import (
    convert_inception_state_dict,
)
from semantic_pyramid_for_image_generation_tpu.train.loop import (
    Trainer as JaxTrainer,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    export_discriminator_state_dict,
    export_generator_state_dict,
)
from semantic_pyramid_for_image_generation_torch.cli import main as cli
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.train.loop import (
    Trainer,
    step_generator,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
)
from test_torch_train_step import CFG, CPU, JCFG, LR, METRICS, _batches, _variables
from torch_inception import randomized_mirror


def _trainer(tmp_path, train, val=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        return Trainer(CFG, train, val, lr=LR, device=CPU,
                       save_data_path=str(tmp_path), allow_random_fid=True,
                       **kw)


def _synthetic(n, batch, validation=False, seed=0):
    rng = np.random.default_rng(seed)
    return [synthetic_batch(CFG, batch, rng, validation=validation)
            for _ in range(n)]


def test_trainer_matches_jax_trainer(tmp_path):
    variables = _variables(CFG)
    batches = _batches(JCFG, 2)
    ref = JaxTrainer(
        JCFG, batches, None, lr=LR, save_data_path=str(tmp_path / "jax"),
        use_mesh=False, g_variables=variables[0], d_variables=variables[1],
        vgg_variables=variables[2],
        inception_variables=convert_inception_state_dict(
            randomized_mirror().state_dict()))
    ref.train(epochs=1, validate_at_start=False, progress=False, log_every=2)
    state = init_train_state(CFG, CPU, lr=LR, g_variables=variables[0],
                             d_variables=variables[1],
                             vgg_variables=variables[2])
    port = _trainer(tmp_path / "port", batches, state=state)
    port.train(epochs=1, validate_at_start=False, progress=False, log_every=2)
    for k in METRICS:
        np.testing.assert_allclose(port.logger.metrics[k], ref.logger.metrics[k],
                                   rtol=2e-3, atol=2e-5, err_msg=k)
    for k in ("iterations", "epoch"):
        assert port.logger.metrics[k] == ref.logger.metrics[k]
    exports = {
        "generator": export_generator_state_dict(
            {"params": ref.state.g_params, "spectral": ref.state.g_spectral,
             "batch_stats": ref.state.g_batch_stats}),
        "discriminator": export_discriminator_state_dict(
            {"params": ref.state.d_params, "spectral": ref.state.d_spectral})}
    for net, share in (("generator", 1e-3), ("discriminator", 0.0)):
        got = dict(getattr(port.state, net).named_parameters())
        off = total = 0
        for key, value in got.items():
            err = (value.detach() - exports[net][key]).abs()
            assert err.max() <= 4 * LR, key
            off += int((err > 1e-2 * LR + 2.0 ** -22 * value.abs()).sum())
            total += err.numel()
        assert off <= share * total, f"{net}: {off} of {total} elements off"
    assert port.state.step == int(jax.device_get(ref.state.step)) == 2


def test_trainer_artifacts_cadence_and_numbering(tmp_path):
    trainer = _trainer(tmp_path, _synthetic(2, 2),
                       _synthetic(1, 2, validation=True, seed=1),
                       fid_device_stats=True)
    trainer.train(epochs=2, validate_after_n_iterations=4,
                  validate_at_start=False, progress=False, log_every=2)
    trainer.train(epochs=1, save_model_after_n_epochs=2,
                  validate_after_n_iterations=10 ** 9,
                  validate_at_start=False, progress=False, log_every=2)
    trainer.train(epochs=1, save_model_after_n_epochs=2,
                  validate_after_n_iterations=10 ** 9,
                  validate_at_start=False, progress=False, log_every=2)
    metrics = trainer.logger.metrics
    # 4 epochs of 2 steps, fetched 2 at a time: every step logged
    assert len(metrics["loss_generator"]) == 8
    assert metrics["iterations"] == [2.0 * i for i in range(1, 9)]
    assert metrics["epoch"] == [float(e) for e in range(4) for _ in range(2)]
    assert trainer.epochs_trained == 4 and trainer.state.step == 8
    # validation every 4 samples in the first call, never in the others
    assert metrics["iterations_fid"] == [4.0, 8.0]
    assert all(np.isfinite(metrics["fid"]))
    with open(os.path.join(trainer.paths["metrics"], "hyperparameter.txt")) as f:
        assert json.load(f)["generator_params"]
    for name in ("loss_generator", "loss_discriminator_real", "fid", "epoch"):
        for ext in ("npy", "pt"):
            assert os.path.exists(os.path.join(trainer.paths["metrics"],
                                               f"{name}.{ext}")), (name, ext)
    ckpts = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(trainer.paths["models"], "checkpoint_*")))
    assert ckpts == ["checkpoint_000.pt", "checkpoint_001.pt",
                     "checkpoint_002.pt"]
    grids = sorted(glob.glob(os.path.join(trainer.paths["plots"],
                                          "predictions_*.png")))
    # at the validations (4, 8) and the epoch ends (4, 8, 12, 16)
    assert sorted(int(p.rsplit("_", 1)[1][:-4]) for p in grids) == [
        4, 8, 12, 16]
    with Image.open(grids[-1]) as img:
        assert img.size == (7 * 256 + 8 * 2,) * 2


def test_grid_is_seven_looped_generates(tmp_path):
    n = 2
    trainer = _trainer(tmp_path, [], _synthetic(1, 3, validation=True, seed=2),
                       write_grids=False)
    rng_state = trainer.rng.get_state()
    before = {k: v.clone() for k, v in
              trainer.state.generator.state_dict().items()}
    assert trainer.inference(num_images=n) is None  # no PNG asked for
    # an eval generate advances no u/v and no batch-norm statistics
    assert all(torch.equal(v, before[k]) for k, v in
               trainer.state.generator.state_dict().items())
    stack = trainer.last_grid
    assert stack.shape == (7 * n, 256, 256, 3)
    batch = trainer._inference_batch
    schedule = MaskSchedule(CFG)
    rng = torch.Generator()
    rng.set_state(rng_state)
    columns = []
    for level in range(7):
        masks = [np.broadcast_to(m[None], (n,) + m.shape).copy()
                 for m in schedule.inference_masks(level)]
        noise = torch.randn((n, CFG.latent_dim), generator=rng)
        columns.append(trainer.generate(batch_to_device(
            {"images": batch["images"][:n], "labels": batch["labels"][:n],
             "masks": masks}, CPU), noise).numpy())
    want = np.stack(columns, axis=1).reshape(stack.shape)
    np.testing.assert_allclose(stack, want, rtol=0, atol=1e-5)
    assert not np.allclose(stack[0], stack[1])  # the levels differ
    assert trainer.state.generator.training  # the mode is restored


def test_resumed_run_draws_the_uninterrupted_noise(tmp_path):
    """Two steps in one run against one step, a checkpoint, and a resumed
    second step: the latents come from (seed + 1, step), so the two runs end
    equal."""
    batches = _synthetic(2, 2, seed=3)
    whole = _trainer(tmp_path / "a", batches, seed=5)
    whole.train(epochs=1, validate_at_start=False, progress=False)
    first = _trainer(tmp_path / "b", batches[:1], seed=5)
    first.train(epochs=1, validate_at_start=False, progress=False)
    resumed = _trainer(tmp_path / "c", batches[1:], seed=5)
    assert not resumed.auto_resume(str(tmp_path / "empty"))
    assert resumed.auto_resume(first.paths["models"])
    resumed.train(epochs=1, validate_at_start=False, progress=False)
    for k in METRICS:
        assert resumed.logger.metrics[k][-1] == whole.logger.metrics[k][-1], k
    a = whole.state.generator.state_dict()
    b = resumed.state.generator.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    g1 = step_generator(6, 1, CPU)
    assert torch.equal(torch.randn(3, generator=g1),
                       torch.randn(3, generator=step_generator(6, 1, CPU)))
    assert not torch.equal(torch.randn(3, generator=step_generator(6, 1, CPU)),
                           torch.randn(3, generator=step_generator(6, 2, CPU)))


# ------------------------------------------------------------------ CLI --


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_but_device():
    got, want = _defaults(cli.build_parser()), _defaults(jax_build_parser())
    assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
    # the port's choice of model, which the JAX package does not have
    assert got.pop("arch") == "semantic-pyramid"
    assert got.pop("image_folder") is None
    assert got == want


@pytest.mark.parametrize("flags,world,match", [
    # --fsdp K shards over the ranks of a --multihost launch
    # (tests/test_torch_fsdp_cli.py) and K must divide them, one process
    # counting one, as the JAX package's make_mesh words it
    (["--fsdp", "2"], 1, "--fsdp 2 shards the state over the ranks of a "
                         "--multihost launch"),
    (["--multihost", "--fsdp", "4"], 1, "device count 1 not divisible by "
                                        "fsdp=4"),
    (["--multihost", "--fsdp", "3"], 2, "device count 2 not divisible by "
                                        "fsdp=3")])
def test_fsdp_flags_that_cannot_shard_raise(flags, world, match, tmp_path,
                                            monkeypatch):
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from torch_parallel_rank import free_port, join, start

    argv = flags + ["--device", "cpu", "--save_data_path", str(tmp_path)]
    if world > 1:
        procs = start(world, ["-m", "semantic_pyramid_for_image_generation_"
                                    "torch.cli.main", *argv])
        with pytest.raises(AssertionError, match="exited") as raised:
            join(procs, timeout=120)
        assert str(raised.value).count(f"ValueError: {match}") == world
        return
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        with pytest.raises(ValueError, match=match):
            cli.main(argv)
    finally:
        mesh.shutdown_distributed()
    assert not mesh.is_distributed()


def test_checkpoint_and_pallas_flags_are_checked():
    args = cli.build_parser().parse_args(["--load_checkpoint", "models/ckpt_3"])
    with pytest.raises(ValueError, match="convert_checkpoint"):
        cli.check_supported(args)
    args = cli.build_parser().parse_args(["--no-pallas"])
    with pytest.raises(ValueError, match="no-pallas"):
        cli.check_supported(args)
    cli.check_supported(cli.build_parser().parse_args(
        ["--no-pallas", "--device", "cpu", "--gpus_to_use", "0,1",
         "--use_data_parallel"]))


@pytest.fixture(scope="module")
def places_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("placesmini")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        lines = []
        for cls in ("abbey", "zoo"):
            (root / split / cls).mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 255, (256, 256, 3),
                                             dtype=np.uint8)).save(
                    root / split / cls / f"{i}.jpg")
                lines.append(f"{split}/{cls}/{i}.jpg")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_cli_trains_tests_and_resumes_on_the_cpu(places_root, tmp_path):
    common = ["--batch_size", "2", "--channel_factor", "8",
              "--vgg_width_factor", "8", "--path_to_places365", places_root,
              "--fid_images", "4", "--num_workers", "2", "--lr", "1e-4",
              "--allow_random_fid", "--validate_after_n_iterations", "1000000",
              "--save_data_path", str(tmp_path / "sd")]
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--train", "--epochs", "1"] + common)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(["--train", "--test", "--epochs", "1", "--device",
                         "cpu"] + common) == 0
    (metrics,) = glob.glob(str(tmp_path / "sd" / "metrics_*"))
    assert len(np.load(os.path.join(metrics, "loss_generator.npy"))) == 2
    (ckpt,) = glob.glob(str(tmp_path / "sd" / "models_*" / "checkpoint_000.pt"))
    grids = glob.glob(str(tmp_path / "sd" / "plots_*" / "predictions_*.png"))
    assert grids
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        args = cli.build_parser().parse_args(
            ["--test", "--device", "cpu", "--load_checkpoint", ckpt] + common)
        trainer = cli.build_trainer(args)
    assert trainer.state.step == 2
    saved = torch.load(ckpt, weights_only=False)["generator"]
    assert all(torch.equal(v, saved[k])
               for k, v in trainer.state.generator.state_dict().items())
    assert np.isfinite(trainer.validate())


def test_import_adam_moments_and_profile_steps(tmp_path):
    """Trainer.import_adam_moments adopts a checkpoint's Adam state without
    its weights; profile_steps writes a chrome trace."""
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_reference_gan_checkpoint,
    )

    batches = _synthetic(1, 2, seed=4)
    source = _trainer(tmp_path / "a", batches, seed=1)
    source.train(epochs=1, validate_at_start=False, progress=False)
    (path,) = glob.glob(os.path.join(source.paths["models"], "*.pt"))
    target = _trainer(tmp_path / "b", batches, seed=2)
    weights = {k: v.clone() for k, v in
               target.state.generator.state_dict().items()}
    target.import_adam_moments(load_reference_gan_checkpoint(path))
    for opt in ("g_optimizer", "d_optimizer"):
        a = getattr(source.state, opt).state_dict()["state"]
        b = getattr(target.state, opt).state_dict()["state"]
        assert a.keys() == b.keys()
        assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])
    assert all(torch.equal(v, weights[k]) for k, v in
               target.state.generator.state_dict().items())
    target.profile_steps(batches[0], str(tmp_path / "trace"), steps=1)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert target.state.step == 1


# ------------------------------------------------------------ the family --


@dataclasses.dataclass(frozen=True)
class StubConfig:
    width: int = 3
    side: int = 4


@dataclasses.dataclass
class StubState:
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_optimizer: torch.optim.Optimizer
    d_optimizer: torch.optim.Optimizer
    step: int = 0


class StubFamily:
    """The least a trained model supplies (train/family.py): linear G and
    D over flat images, one update of each a step."""

    refusal, refuses = "the stub trains alone", ("fsdp",)

    def init_state(self, config, device, seed, lr):
        torch.manual_seed(seed)
        pixels = config.side * config.side * 3
        generator = torch.nn.Linear(config.width, pixels)
        discriminator = torch.nn.Linear(pixels, 1)
        generator.config = config
        return StubState(generator, discriminator,
                          torch.optim.Adam(generator.parameters(), lr=lr),
                          torch.optim.Adam(discriminator.parameters(), lr=lr))

    def make_step(self, **options):
        def step(state, batch, rng):
            real = batch["images"].flatten(1).float()
            noise = torch.randn((real.shape[0], state.generator.in_features),
                                generator=rng)
            loss_real = (state.discriminator(real) - 1).square().mean()
            loss_fake = state.discriminator(
                state.generator(noise).detach()).square().mean()
            state.d_optimizer.zero_grad()
            (loss_real + loss_fake).backward()
            state.d_optimizer.step()
            loss_g = (state.discriminator(state.generator(noise))
                      - 1).square().mean()
            state.g_optimizer.zero_grad()
            loss_g.backward(inputs=list(state.generator.parameters()))
            state.g_optimizer.step()
            state.step += 1
            return state, {"loss_discriminator_real": loss_real.detach(),
                           "loss_discriminator_fake": loss_fake.detach(),
                           "loss_generator": loss_g.detach()}
        return step

    def hyperparameters(self, lr, w_rec, w_div):
        return {"lr": str(lr)}

    def progress(self, fid, host):
        return f"FID={fid:.4f}, Loss G={host['loss_generator']:.4f}"

    def latent_dim(self, config):
        return config.width

    def sample(self, state, batch, noise):
        side = state.generator.config.side
        with torch.no_grad():
            return state.generator(noise).reshape(-1, side, side, 3)

    def grid(self, config, state, images, labels, rng, device):
        noise = torch.randn((images.shape[0], config.width), generator=rng)
        return self.sample(state, {}, noise).numpy(), images.shape[0]

    def checkpoint(self, state):
        return {"generator": state.generator.state_dict(),
                "discriminator": state.discriminator.state_dict(),
                "generator_optimizer": state.g_optimizer.state_dict(),
                "discriminator_optimizer": state.d_optimizer.state_dict(),
                "step": state.step}

    def restore(self, path, state):
        checkpoint = torch.load(path, weights_only=False)
        state.generator.load_state_dict(checkpoint["generator"])
        state.discriminator.load_state_dict(checkpoint["discriminator"])
        state.g_optimizer.load_state_dict(checkpoint["generator_optimizer"])
        state.d_optimizer.load_state_dict(
            checkpoint["discriminator_optimizer"])
        state.step = checkpoint["step"]
        return state


def test_a_stub_family_trains_checkpoints_and_resumes(tmp_path,
                                                      monkeypatch):
    """A new model costs one family object and its entry in the one
    lookup: the Trainer and train/checkpoint.py stay as they are. An epoch
    of two steps logs both, writes the family's grid and checkpoint_000.pt;
    `auto_resume` in a fresh Trainer restores it bitwise; the family's
    refusal is raised."""
    from semantic_pyramid_for_image_generation_torch.train import family

    monkeypatch.setitem(family.FAMILIES, StubConfig, StubFamily())
    rng = np.random.default_rng(0)
    batches = [{"images": rng.random((2, 4, 4, 3), np.float32),
                "labels": np.arange(2)} for _ in range(2)]

    def trainer(name, seed, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-init FID warning
            return Trainer(StubConfig(), batches, batches[:1], lr=1e-2,
                           device=CPU, seed=seed, allow_random_fid=True,
                           save_data_path=str(tmp_path / name), **kw)

    trained = trainer("a", seed=1)
    trained.train(epochs=1, validate_at_start=False, progress=False)
    assert trained.state.step == 2
    assert len(trained.logger.metrics["loss_generator"]) == 2
    assert trained.logger.hyperparameter["lr"] == "0.01"
    assert trained.last_grid.shape == (7, 4, 4, 3)
    assert glob.glob(os.path.join(trained.paths["plots"], "*.png"))
    resumed = trainer("b", seed=2)
    assert resumed.auto_resume(trained.paths["models"])
    assert resumed.state.step == 2
    for net in ("generator", "discriminator"):
        a = getattr(trained.state, net).state_dict()
        b = getattr(resumed.state, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
    for opt in ("g_optimizer", "d_optimizer"):
        a = getattr(trained.state, opt).state_dict()["state"]
        b = getattr(resumed.state, opt).state_dict()["state"]
        assert all(torch.equal(a[i][m], b[i][m]) for i in a for m in a[i])
    with pytest.raises(ValueError, match="the stub trains alone; refused: "
                                         "fsdp"):
        trainer("c", seed=3, fsdp=2)
