"""The port's fused train step against the JAX package's `make_train_step`.

Both sides start from one state: the port's seeded init with spectral u/v
advanced 10 power iterations (sigma near the layers' spectral norms, so
activations stay O(1)), carried into the JAX package by its own converters
(`convert_*_state_dict`) and back into the port through the port's bridge
(`init_train_state(g_variables=...)`). Batches come from the JAX package's
`synthetic_batch` on a numpy seed, with both phases' latents pinned
through `noise_d` / `noise_g`, so both frameworks see identical inputs.

Tolerances (fp32, two steps, lr 1e-5):
  * the five metrics per step: rtol 2e-3, atol 2e-5, the bar the JAX
    package holds its own step to against the reference loop
    (tests/test_full_step_parity.py). Summation order is the only
    difference, amplified by two Adam steps.
  * post-update G and D parameters: |port - jax| <= 1e-2 * lr plus one fp32
    ulp of the parameter, so each Adam step agrees to 1% of its size (an
    absolute 1e-4 would say nothing at lr 1e-5; the ulp term is the fp32
    spacing of parameters of magnitude ~1, 1.2e-7 = 1.2e-2 * lr). D holds
    this on every element. G holds it on all but 0.1% of its elements, and
    every element within 4 * lr (two Adam steps of opposite sign): Adam
    divides each gradient element by its own magnitude, so an element whose
    gradient is at the fp32 noise floor (~1e-5 of G's largest gradient)
    takes a +-lr step of either sign in either framework. G has whole
    tensors of such elements: batch statistics remove every bias that feeds
    a training-mode batch norm (each block's conv_1, the last two blocks'
    outputs, the attention's value and output convs, which reach only batch
    norms), and the softmax removes the key conv's bias, so their gradients
    are zero in exact arithmetic (304 elements at tiny width). Measured
    at these inputs: 0.03% of G's elements outside the bound, 0 of D's.
    The gradients themselves are held per tensor in
    tests/test_torch_train_grads.py.
  * spectral u/v after each step: 1e-4 absolute (unit vectors; 3 G and 3 D
    advances per step).
  * batch-norm running statistics after each step: 1e-6 absolute plus 3e-4
    relative, as the JAX package holds them (fp32 reduction order of the
    batch moments). One exception after the second step: the final BN's
    running mean averages its input, which carries the last block's three
    zero-gradient biases, whose first Adam steps are +-lr of either sign
    (above): up to 3 biases x 2 lr of difference enter two momentum-0.1
    updates, 0.19 * 6 lr = 1.2e-5, so it is held to 2e-5 absolute.
bf16, one step: the metrics within 5% relative plus 1e-3 absolute. The two
frameworks round at other places in bf16 (bias adds, the upsample's
intermediate, the attention backward's p), and the losses are means of
O(1) terms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch,
)
from semantic_pyramid_for_image_generation_tpu.train import state as jstate
from semantic_pyramid_for_image_generation_tpu.train.step import (
    make_train_step as jax_make_train_step,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    convert_generator_state_dict,
    convert_vgg16_state_dict,
    export_discriminator_state_dict,
    export_generator_state_dict,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
    param_count,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_generate_fn,
    make_train_step,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
)

CFG = PyramidGANConfig().tiny()
JCFG = JaxConfig().tiny()
CPU = torch.device("cpu")
LR = 1e-5
BATCH = 2
METRICS = ("loss_discriminator_real", "loss_discriminator_fake",
           "loss_generator", "loss_generator_semantic_reconstruction",
           "loss_generator_diversity")


def _variables(cfg, seed=0):
    """Port init from `seed`, u/v advanced 10 iterations, as JAX variables."""
    state = init_train_state(cfg, CPU, lr=LR, seed=seed)
    advance_spectral_norm_(state.generator, 10)
    advance_spectral_norm_(state.discriminator, 10)
    return (convert_generator_state_dict(state.generator.state_dict()),
            convert_discriminator_state_dict(state.discriminator.state_dict()),
            convert_vgg16_state_dict(state.vgg.state_dict()))


def _batches(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = jax_synthetic_batch(cfg, BATCH, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal(
                (BATCH, cfg.latent_dim)).astype(np.float32)
        out.append(batch)
    return out


def _run_jax(jcfg, variables, batches, mesh=None, **step_flags):
    """The JAX step over `batches` from `variables`; with a JAX `mesh`, on
    the state and batches sharded over it (`shard_state`, `shard_batch`).
    The metrics and the G and D state dicts after each step."""
    from semantic_pyramid_for_image_generation_tpu.parallel import (
        shard_batch,
        shard_state,
    )

    g_vars, d_vars, v_vars = variables
    g_tx, d_tx = jstate.make_optimizers(LR)
    state = jstate.init_train_state(
        jax.random.key(0), jcfg, g_tx, d_tx, vgg_variables=v_vars,
        g_variables=g_vars, d_variables=d_vars)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = jax_make_train_step(*jstate.make_models(jcfg), g_tx, d_tx,
                               donate=False, **step_flags)
    metrics, snapshots = [], []
    for batch in batches:
        batch = jax.tree.map(jnp.asarray, batch)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, m = step(state, batch, jax.random.key(7))
        metrics.append({k: float(m[k]) for k in METRICS})
        snapshots.append({
            "generator": export_generator_state_dict(
                {"params": state.g_params, "spectral": state.g_spectral,
                 "batch_stats": state.g_batch_stats}),
            "discriminator": export_discriminator_state_dict(
                {"params": state.d_params, "spectral": state.d_spectral})})
    return metrics, snapshots


def _run_port(cfg, variables, batches, **step_flags):
    g_vars, d_vars, v_vars = variables
    state = init_train_state(cfg, CPU, lr=LR, g_variables=g_vars,
                             d_variables=d_vars, vgg_variables=v_vars)
    step = make_train_step(**step_flags)
    metrics, snapshots = [], []
    for batch in batches:
        state, m = step(state, batch_to_device(batch, CPU))
        metrics.append({k: float(m[k]) for k in METRICS})
        snapshots.append({
            net: {k: v.detach().clone()
                  for k, v in getattr(state, net).state_dict().items()}
            for net in ("generator", "discriminator")})
    return metrics, snapshots


@pytest.fixture(scope="module")
def fp32_runs():
    variables = _variables(CFG)
    batches = _batches(JCFG, 2)
    return _run_jax(JCFG, variables, batches), _run_port(CFG, variables, batches)


def assert_metrics_match(port_metrics, jax_metrics):
    """The module docstring's bar for the metrics of each step."""
    for step, (got, want) in enumerate(zip(port_metrics, jax_metrics)):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5,
                                       err_msg=f"step {step} {k}")


def assert_parameters_match(got, want, share):
    """The module docstring's bar for one network's post-update parameters
    (state dicts): every element within 4 lr, at most `share` of them
    further than 1% of an Adam step plus one fp32 ulp."""
    params = [k for k in got if not k.endswith(
        ("weight_u", "weight_v", "running_mean", "running_var",
         "num_batches_tracked"))]
    assert set(params) <= set(want)
    off = total = 0
    for key in params:
        err = (got[key] - want[key]).abs()
        assert err.max() <= 4 * LR, key
        off += int((err > 1e-2 * LR + 2.0 ** -22 * want[key].abs()).sum())
        total += err.numel()
    assert off <= share * total, f"{off} of {total} elements off"


def assert_spectral_and_batch_stats_match(got, want, step):
    """The module docstring's bar for one network's u/v and running
    statistics after step `step` (0-based)."""
    uv = [k for k in want if k.endswith(("weight_u", "weight_v"))]
    assert uv
    for key in uv:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-4,
                                   msg=key)
    for key in (k for k in want if k.endswith(("running_mean", "running_var"))):
        atol = 2e-5 if (step, key) == (1, "final_block.1.running_mean") else 1e-6
        torch.testing.assert_close(got[key], want[key], rtol=3e-4, atol=atol,
                                   msg=key)


def test_two_fp32_steps_metrics_match_jax(fp32_runs):
    (jax_metrics, _), (port_metrics, _) = fp32_runs
    assert_metrics_match(port_metrics, jax_metrics)


@pytest.mark.parametrize("net,share", [("generator", 1e-3),
                                       ("discriminator", 0.0)])
def test_two_fp32_steps_parameters_match_jax(fp32_runs, net, share):
    (_, jax_snapshots), (_, port_snapshots) = fp32_runs
    assert_parameters_match(port_snapshots[-1][net], jax_snapshots[-1][net],
                            share)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("step", [0, 1])
def test_fp32_steps_spectral_and_batch_stats_match_jax(fp32_runs, net, step):
    (_, jax_snapshots), (_, port_snapshots) = fp32_runs
    assert_spectral_and_batch_stats_match(port_snapshots[step][net],
                                          jax_snapshots[step][net], step)


def test_one_bf16_step_metrics_match_jax_in_band():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    jcfg = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    variables = _variables(cfg, seed=1)
    batches = _batches(jcfg, 1, seed=6)
    want, _ = _run_jax(jcfg, variables, batches)
    got, _ = _run_port(cfg, variables, batches)
    for k in METRICS:
        assert np.isfinite(got[0][k]), k
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=5e-2,
                                   atol=1e-3, err_msg=k)


def test_synthetic_batch_matches_jax_package():
    want = jax_synthetic_batch(JCFG, 3, np.random.default_rng(11))
    got = synthetic_batch(CFG, 3, np.random.default_rng(11))
    for key in ("images", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
    assert len(got["masks"]) == len(want["masks"]) == 7
    for g, w in zip(got["masks"], want["masks"]):
        np.testing.assert_array_equal(g, w)


def test_param_counts_at_full_width():
    with torch.device("meta"):
        from semantic_pyramid_for_image_generation_torch.models.discriminator import (  # noqa: E501
            Discriminator,
        )
        from semantic_pyramid_for_image_generation_torch.models.generator import (
            Generator,
        )

        g, d = Generator(PyramidGANConfig()), Discriminator(PyramidGANConfig())
    assert param_count(g) == 29_967_047
    assert param_count(d) == 16_820_994


def _tiny_batch(seed=3):
    batch = synthetic_batch(CFG, BATCH, np.random.default_rng(seed))
    return batch_to_device(batch, CPU)


def test_frozen_spectral_state_keeps_u_and_v():
    state = init_train_state(CFG, CPU, lr=LR, seed=2)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)  # from random u/v sigma is tiny
    before = {k: v.clone() for k, v in state.discriminator.state_dict().items()
              if k.endswith("weight_u")}
    state, metrics = make_train_step(spectral_update=False)(
        state, _tiny_batch(), torch.Generator().manual_seed(0))
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = state.discriminator.state_dict()
    for key, value in before.items():
        torch.testing.assert_close(after[key], value, rtol=0, atol=0)
    state, _ = make_train_step()(state, _tiny_batch(),
                                 torch.Generator().manual_seed(0))
    moved = state.discriminator.state_dict()
    assert sum(not torch.equal(moved[k], v) for k, v in before.items()) > 10


def test_step_leaves_vgg_frozen_and_moves_g_and_d():
    state = init_train_state(CFG, CPU, lr=1e-4, seed=4)
    vgg = {k: v.clone() for k, v in state.vgg.state_dict().items()}
    g0 = state.generator.linear_layer.weight_orig.detach().clone()
    d0 = state.discriminator.classification.weight_orig.detach().clone()
    make_train_step()(state, _tiny_batch(), torch.Generator().manual_seed(1))
    for k, v in state.vgg.state_dict().items():
        assert torch.equal(v, vgg[k]), k
    assert all(p.grad is None for p in state.vgg.parameters())
    assert not torch.equal(state.generator.linear_layer.weight_orig, g0)
    assert not torch.equal(state.discriminator.classification.weight_orig, d0)


def test_generate_after_training_reads_no_stale_weights():
    """An eval generate caches each layer's normalized weight; after a train
    step (new W, u, v) the next eval generate must use the new weights: it
    equals a fresh model loaded from the trained state dict."""
    state = init_train_state(CFG, CPU, lr=1e-3, seed=5)
    batch = _tiny_batch(seed=6)
    args = (batch["images"], batch["masks"], batch["labels"],
            torch.from_numpy(np.random.default_rng(7).standard_normal(
                (BATCH, CFG.latent_dim)).astype(np.float32)))
    state.generator.eval()
    make_generate_fn(state.generator, state.vgg)(*args)  # fills the caches
    make_train_step()(state, batch, torch.Generator().manual_seed(2))
    state.generator.eval()
    got = make_generate_fn(state.generator, state.vgg)(*args)
    fresh = init_train_state(CFG, CPU, seed=9)
    fresh.generator.load_state_dict(state.generator.state_dict())
    fresh.generator.eval()
    want = make_generate_fn(fresh.generator, state.vgg)(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_step_calls_each_kernel_wrapper_as_the_card_counts(monkeypatch):
    """The launches per step that chip_smoke.py checks on the card, counted
    here at the wrappers: 5 attention, 22 upsample, 30 max pool, 14 max-pool
    backward, 11 upsample backward; none of the batch norms' four in this
    float32 step (they run bf16 training norms)."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda import (
        attention,
        batch_norm,
        pool,
        resize,
    )

    calls = dict.fromkeys(kernels.launch_counts(), 0)
    for module, fn, name in (
            (attention, "pooled_kv_attention", "pooled_kv_attention"),
            (pool, "max_pool_2x2", "max_pool_2x2"),
            (pool, "max_pool_2x2_backward", "max_pool_2x2_backward"),
            (resize, "upsample_2x", "upsample_2x"),
            (resize, "upsample_2x_backward", "upsample_2x_backward"),
            *((batch_norm, n, n) for n in (
                "batch_norm_stats", "batch_norm_apply",
                "batch_norm_backward_sums", "batch_norm_backward_dx"))):
        def counted(*args, _f=getattr(module, fn), _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(module, fn, counted)
    state = init_train_state(CFG, CPU, seed=8)
    make_train_step()(state, _tiny_batch(), torch.Generator().manual_seed(3))
    assert calls == {"pooled_kv_attention": 5, "max_pool_2x2": 30,
                     "upsample_2x": 22, "max_pool_2x2_backward": 14,
                     "upsample_2x_backward": 11, "batch_norm_stats": 0,
                     "batch_norm_apply": 0, "batch_norm_backward_sums": 0,
                     "batch_norm_backward_dx": 0}


def test_exact_float32_covers_the_autograd_backward():
    """cuDNN's TF32 switch is process-wide, so the backward, which autograd
    runs on its own thread for CUDA tensors, sees exact_float32's setting."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.backends.cudnn.allow_tf32)
            return g * 2

    x = torch.ones(3, requires_grad=True)
    with exact_float32():
        Probe.apply(x).sum().backward()
    assert seen == [False]
