"""The train-step perf modes within the port, at tiny() in fp32 on the CPU.

  * `remat_vgg`, `remat_blocks` and both equal the plain step bitwise over
    two steps with spectral updates on: metrics, G and D parameters, u/v,
    running statistics and both Adam states after each step. The recompute
    re-runs the same float32 arithmetic in the same order, and its guard
    (models/layers.py::RecomputeGuard) replays each spectral layer's u/v
    and skips the running statistics' momentum step.
  * With the guard off (a plain checkpoint, the planted fault
    `recompute_unguarded` of tests/torch_parallel_rank.py) u/v and the
    running statistics differ from the plain step: the hold has teeth.
    With only u/v unguarded, or only the running statistics' momentum
    taken twice, the first step moves just that state.
  * `fused_discriminator` against the separate passes over three steps
    with spectral updates frozen, as the JAX package holds its own fused
    mode (tests/test_train_step.py): the metrics within rtol 1e-5 / atol
    1e-7, u/v untouched. PyTorch's CPU convolution sums a 2B-row batch in
    another order than a B-row one, so the gradients differ at fp32 noise
    and the parameters are held by Adam rules: an element whose gradient
    is at the noise floor (zero in exact arithmetic, as for G's BN-fed
    biases) steps +-lr either way. Measured over batch seeds 5-7 on one
    and on four threads: 311-436 of G's 1,410,916 elements off (at most
    3.1e-4 of them, 3.4 lr), held at tests/test_torch_train_step.py's
    share of 1e-3; 0 or 1 of D's 276,146, whose first gradient is at most
    7.1e-9 of D's largest, so D is held to its noise floor (`NOISE_FLOOR`:
    an element off must have a first gradient within 1e-6 of the largest);
    the running statistics as there (the final BN's mean, which those
    biases feed, 2.9e-6 off), the third step's fake loss 5e-7. With updates
    on, the first step's real loss agrees: the fake pass of the separate
    step is the one that sees a second advance of D's u/v. The two planted
    faults of the fused pass (the fakes' labels shifted a row, D's u/v
    advanced once more) break this hold. It raises on the (B, B, 128)
    projection.
  * The kernel wrappers' calls per step in each mode.
  * Two gloo ranks with `--fused_d --remat_blocks` against one process on
    the concatenated batch under tests/test_torch_train_step.py's bars, D
    at its noise floor as above (over batch seeds 4, 8 and 9: G 2.9e-4 to
    5.9e-4 of its elements off, D none), the ranks bitwise equal, and the
    bytes each rank all-reduces and gathers as `step_collective_bytes`
    works them out.
  * The CLI: the flags' config and step flags, and a two-step training
    run with all three that writes its checkpoint.
"""

import dataclasses
import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch.cli import main as cli
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda import (
    attention,
    batch_norm,
    pool,
    resize,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    SP_GAN,
    batch_to_device,
    make_train_step,
)
from test_torch_cli import places_root  # noqa: F401  (a fixture)
from test_torch_train_step import (
    assert_metrics_match,
    assert_parameters_match,
    assert_spectral_and_batch_stats_match,
)
from torch_parallel_rank import (
    BATCH_NORM_KERNELS,
    CANONICAL,
    PERF_MODE_LAUNCHES,
    PERF_MODES,
    WORKER,
    build_state,
    float32_launches,
    gradients,
    join,
    planted,
    snapshot,
    start,
    step_collective_bytes,
    step_run,
    tree_equal,
)

CFG = PyramidGANConfig().tiny()
CPU = torch.device("cpu")
LR = 1e-5
BATCH = 2
FUSED = PERF_MODES["fused_d"][1]
REMAT = ("remat_vgg", "remat_blocks", "remat_both")
NOISE_FLOOR = 1e-6  # of a network's largest first-step gradient


def _state(cfg):
    state = init_train_state(cfg, CPU, lr=LR, seed=0)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)  # from random u/v sigma is tiny
    return state


def _batches(cfg, n, rows=BATCH, seed=5):
    """`n` numpy batches of `rows` with pinned latents."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = synthetic_batch(cfg, rows, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal(
                (rows, cfg.latent_dim)).astype(np.float32)
        out.append(batch)
    return out


def _run(cfg, steps=2, **step_flags):
    """The metrics of each step and, after each, G's and D's state dicts
    and both Adam states; the first snapshot also holds the first step's
    gradients."""
    state = _state(cfg)
    step = make_train_step(**step_flags)
    metrics, snapshots = [], []
    for batch in _batches(cfg, steps):
        state, m = step(state, batch_to_device(batch, CPU))
        metrics.append({k: float(v) for k, v in m.items()})
        snapshots.append(snapshot(state))
        snapshots[0].setdefault("grads", gradients(state))
    return metrics, snapshots


def assert_off_only_at_noise_floor(got, want, grads):
    """A network's post-update parameters (state dicts) where its pass sums
    the batch in another order: every element within 4 lr, and every
    element further than 1% of an Adam step plus one fp32 ulp has a first
    gradient (`grads`, the reference's) within NOISE_FLOOR of the largest,
    zero in exact arithmetic, so that its Adam steps go +-lr either way."""
    largest = max(float(g.abs().max()) for g in grads.values())
    for key, grad in grads.items():
        err = (got[key] - want[key]).abs()
        assert err.max() <= 4 * LR, key
        off = err > 1e-2 * LR + 2.0 ** -22 * want[key].abs()
        assert (grad[off].abs() <= NOISE_FLOOR * largest).all(), (
            f"{key}: {int(off.sum())} elements off, first gradients up to "
            f"{float(grad[off].abs().max()):.3g} of {largest:.3g}")


@pytest.fixture(scope="module")
def plain():
    return _run(CFG)


@pytest.mark.parametrize("mode", REMAT)
def test_remat_equals_the_plain_step_bitwise(plain, mode):
    fields, flags = PERF_MODES[mode]
    metrics, snapshots = _run(dataclasses.replace(CFG, **fields), **flags)
    assert metrics == plain[0]
    for step, (got, want) in enumerate(zip(snapshots, plain[1])):
        for part in want:
            assert tree_equal(got[part], want[part]), (step, part)


def test_unguarded_recompute_breaks_the_hold(plain):
    with planted("recompute_unguarded"):
        _, snapshots = _run(dataclasses.replace(CFG, remat_blocks=True))
    got, want = snapshots[-1], plain[1][-1]
    for net, kinds in (("generator", ("weight_u", "running_mean")),
                       ("discriminator", ("weight_u",))):
        for kind in kinds:
            moved = [k for k in want[net] if k.endswith(kind)
                     and not torch.equal(got[net][k], want[net][k])]
            assert moved, (net, kind)


@pytest.mark.parametrize("fault,uv_moves,bn_moves", [
    ("recompute_unguarded", True, True),
    ("recompute_uv_unguarded", True, False),
    ("recompute_bn_twice", False, True)])
def test_recompute_faults_move_their_state(plain, fault, uv_moves, bn_moves):
    with planted(fault):
        _, snapshots = _run(dataclasses.replace(CFG, remat_blocks=True))
    got, want = snapshots[0], plain[1][0]
    for kinds, moves in ((("weight_u", "weight_v"), uv_moves),
                         (("running_mean", "running_var"), bn_moves)):
        moved = [k for net in ("generator", "discriminator")
                 for k in want[net] if k.endswith(kinds)
                 and not torch.equal(got[net][k], want[net][k])]
        assert bool(moved) == moves, (kinds, moved)


def assert_fused_holds(fused_run, separate_run):
    """The fused step against the separate passes over three steps with
    spectral updates frozen (the module docstring's bars)."""
    (fused_metrics, fused), (sep_metrics, sep) = fused_run, separate_run
    for step, (got, want) in enumerate(zip(fused_metrics, sep_metrics)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step}: {k}")
    initial = _state(dataclasses.replace(CFG, **CANONICAL))
    for net in ("generator", "discriminator"):
        got, want = fused[-1][net], sep[-1][net]
        if net == "generator":
            assert_parameters_match(got, want, 1e-3)
        else:
            assert_off_only_at_noise_floor(got, want, sep[0]["grads"][net])
        for key, value in getattr(initial, net).state_dict().items():
            if key.endswith(("weight_u", "weight_v")):
                assert torch.equal(got[key], value), key
                assert torch.equal(want[key], value), key
            elif key.endswith(("running_mean", "running_var")):
                atol = 2e-5 if key == "final_block.1.running_mean" else 1e-6
                torch.testing.assert_close(got[key], want[key], rtol=3e-4,
                                           atol=atol, msg=key)


@pytest.fixture(scope="module")
def separate():
    """Three steps of the separate D passes, spectral updates frozen."""
    return _run(dataclasses.replace(CFG, **CANONICAL), steps=3,
                spectral_update=False)


def test_fused_d_equals_separate_passes_with_spectral_state_frozen(separate):
    cfg = dataclasses.replace(CFG, **CANONICAL)
    assert_fused_holds(_run(cfg, steps=3, spectral_update=False, **FUSED),
                       separate)


@pytest.mark.parametrize("fault", ["fused_labels_shifted",
                                   "fused_uv_advanced"])
def test_fused_faults_break_the_hold(separate, fault):
    cfg = dataclasses.replace(CFG, **CANONICAL)
    with planted(fault):
        fused = _run(cfg, steps=3, spectral_update=False, **FUSED)
    with pytest.raises(AssertionError):
        assert_fused_holds(fused, separate)


def test_fused_d_first_step_real_loss_matches_separate_passes():
    cfg = dataclasses.replace(CFG, **CANONICAL)
    (sep, *_), _ = _run(cfg, steps=1)
    (fused, *_), _ = _run(cfg, steps=1, **FUSED)
    np.testing.assert_allclose(fused["loss_discriminator_real"],
                               sep["loss_discriminator_real"], rtol=1e-5)


def test_fused_d_needs_the_canonical_projection():
    state = _state(CFG)
    batch = batch_to_device(_batches(CFG, 1)[0], CPU)
    with pytest.raises(ValueError, match="compat_projection"):
        make_train_step(**FUSED)(state, batch)


WRAPPERS = ((attention, "pooled_kv_attention"), (pool, "max_pool_2x2"),
            (resize, "upsample_2x"), (pool, "max_pool_2x2_backward"),
            (resize, "upsample_2x_backward"),
            *((batch_norm, name) for name in BATCH_NORM_KERNELS))


def _wrapper_calls(monkeypatch, mode, dtype):
    """Calls of the nine kernel wrappers in one step of `mode` at `dtype`."""
    fields, flags = PERF_MODES[mode]
    calls = dict.fromkeys([name for _, name in WRAPPERS], 0)
    for module, name in WRAPPERS:
        def counted(*args, _f=getattr(module, name), _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(module, name, counted)
    cfg = dataclasses.replace(CFG, compute_dtype=dtype, **fields)
    make_train_step(**flags)(_state(cfg), batch_to_device(
        _batches(cfg, 1)[0], CPU))
    return calls


@pytest.mark.parametrize("mode", list(PERF_MODES))
def test_kernel_wrapper_calls_per_step(monkeypatch, mode):
    """Calls per float32 step of the kernel wrappers in each mode, as
    PERF_MODE_LAUNCHES (tests/torch_parallel_rank.py) works them out: the
    batch norms' none."""
    assert _wrapper_calls(monkeypatch, mode, "float32") == float32_launches(
        PERF_MODE_LAUNCHES[mode])


@pytest.mark.parametrize("mode", list(PERF_MODES))
def test_kernel_wrapper_calls_per_bf16_step(monkeypatch, mode):
    """Calls per bfloat16 step, what the card counts in each mode: the
    batch norms' too, the remat_blocks recompute's included."""
    assert _wrapper_calls(monkeypatch, mode, "bfloat16") == \
        PERF_MODE_LAUNCHES[mode]


def test_two_gloo_ranks_with_fused_d_and_remat_blocks(tmp_path):
    cfg = dataclasses.replace(CFG, remat_blocks=True, **CANONICAL)
    state = _state(cfg)
    inputs = {"config": dataclasses.asdict(cfg), "lr": LR,
              "batches": _batches(cfg, 2, rows=2 * BATCH, seed=4)}
    for net in ("generator", "discriminator", "vgg"):
        inputs[net] = getattr(state, net).state_dict()
    torch.save(inputs, tmp_path / "inputs.pt")
    spec = {"device": "cpu", "inputs": str(tmp_path / "inputs.pt"),
            "out": str(tmp_path), "runs": ["sound"], "step_flags": FUSED}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    procs = start(2, [WORKER, str(tmp_path / "spec.json")])
    try:
        state = build_state(inputs, CPU)
        one = step_run(state, inputs["batches"], CPU, 1, 0, **FUSED)
        one.update(snapshot(state))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    join(procs, timeout=240)
    ranks = [torch.load(tmp_path / f"sound_rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert tree_equal(ranks[0], ranks[1])
    got = ranks[0]
    assert_metrics_match(got["metrics"], one["metrics"])
    assert_parameters_match(got["generator"], one["generator"], 1e-3)
    assert_off_only_at_noise_floor(got["discriminator"], one["discriminator"],
                                   one["grads"]["discriminator"])
    for net in ("generator", "discriminator"):
        assert_spectral_and_batch_stats_match(got[net], one[net], step=1)
        ref = one["grads"][net]
        num = sum(float((got["grads"][net][k] - ref[k]).square().sum())
                  for k in ref)
        den = sum(float(ref[k].square().sum()) for k in ref)
        assert (num / den) ** 0.5 <= 1e-3, net
    per_step = step_collective_bytes(state, BATCH, 2)
    assert got["collective_bytes"] == {k: 2 * v for k, v in per_step.items()}
    assert per_step["all_gather"] == 2 * BATCH * (3 * 256 * 256 + 128) * 4


@pytest.mark.parametrize("flags,compat_projection,remat_blocks", [
    ([], True, False), (["--fused_d"], False, False),
    (["--remat_vgg"], True, False), (["--remat_blocks"], True, True),
    (["--canonical_projection"], False, False),
    (["--fused_d", "--remat_vgg", "--remat_blocks"], False, True)])
def test_perf_flags_map_to_the_config(flags, compat_projection, remat_blocks):
    args = cli.build_parser().parse_args(flags + ["--device", "cpu"])
    cli.check_supported(args)
    config = cli.config_from_args(args)
    assert config.compat_projection == compat_projection
    assert config.remat_blocks == remat_blocks


def test_cli_trains_two_steps_with_all_perf_modes(places_root, tmp_path,  # noqa: F811
                                                  monkeypatch):
    seen = []

    def recorded(**flags):
        seen.append(flags)
        return make_train_step(**flags)

    monkeypatch.setattr(SP_GAN, "make_step", recorded)  # the Trainer's step
    save = tmp_path / "sd"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main([
            "--train", "--device", "cpu", "--fused_d", "--remat_vgg",
            "--remat_blocks", "--epochs", "1", "--batch_size", "2",
            "--channel_factor", "8", "--vgg_width_factor", "8",
            "--path_to_places365", places_root, "--fid_images", "4",
            "--num_workers", "2", "--allow_random_fid", "--fid_device_stats",
            "--validate_after_n_iterations", "1000000",
            "--save_data_path", str(save)]) == 0
    assert seen == [{"w_rec": 0.1, "w_div": 0.1, "remat_vgg": True,
                     "fused_discriminator": True}]
    (ckpt,) = glob.glob(str(save / "models_*" / "checkpoint_000.pt"))
    assert torch.load(ckpt, weights_only=False)["step"] == 2
    (metrics,) = glob.glob(str(save / "metrics_*"))
    losses = np.load(os.path.join(metrics, "loss_discriminator_real.npy"))
    assert len(losses) == 2 and np.isfinite(losses).all()
