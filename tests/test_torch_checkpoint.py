"""The port's `.pt` checkpoints against the JAX package's reader and writer.

Both directions use the reference `checkpoint_XXX.pt` layout
({"generator", "discriminator", "generator_optimizer",
"discriminator_optimizer"}; the port adds "step"):
  * port -> JAX: the JAX package's `load_reference_gan_checkpoint(...,
    include_optimizer=True)` reads a port checkpoint with the port's
    weights, u/v, batch-norm statistics and Adam moments, key for key,
    bitwise (the same fp32 tensors, transposed and back);
  * JAX -> port: a JAX state after one step, written by the JAX package's
    `save_reference_gan_checkpoint`, resumes in the port, and the port's next
    step matches JAX's next step under tests/test_torch_train_step.py's
    tolerances (fp32, tiny(), pinned noise): metrics rtol 2e-3 / atol 2e-5;
    parameters within 1e-2 * lr plus one fp32 ulp on all of D's elements
    and all but 0.1% of G's, every element within 4 * lr; u/v 1e-4; batch-
    norm statistics 1e-6 + 3e-4 relative;
  * the JAX export numbers its Adam ids in its own key order, which differs
    from the port's `parameters()` order (each attention's `gamma`): the
    port maps moments by key, and they land on the right tensors bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.train import state as jstate
from semantic_pyramid_for_image_generation_tpu.train.step import (
    make_train_step as jax_make_train_step,
)
from semantic_pyramid_for_image_generation_tpu.utils import (
    pt_interop as jax_pt,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    import_adam_moments,
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_generate_fn,
    make_train_step,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    load_reference_gan_checkpoint,
    parameter_keys,
)
from test_torch_train_step import (
    CFG,
    CPU,
    JCFG,
    LR,
    METRICS,
    _batches,
    _variables,
)

EXPORTS = {"generator": jax_pt.export_generator_state_dict,
           "discriminator": jax_pt.export_discriminator_state_dict}


def _trained_port_state(seed=0, steps=1):
    state = init_train_state(CFG, CPU, lr=LR, seed=seed)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)
    step = make_train_step()
    for batch in _batches(JCFG, steps, seed=seed + 20):
        step(state, batch_to_device(batch, CPU))
    return state


def _jax_variables(state, net):
    if net == "generator":
        return {"params": state.g_params, "spectral": state.g_spectral,
                "batch_stats": state.g_batch_stats}
    return {"params": state.d_params, "spectral": state.d_spectral}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX: one step, the state saved by the JAX writer, then a second step.
    Returns (path, second-step metrics, state after it)."""
    g_vars, d_vars, v_vars = _variables(CFG)
    batches = _batches(JCFG, 2)
    g_tx, d_tx = jstate.make_optimizers(LR)
    state = jstate.init_train_state(
        jax.random.key(0), JCFG, g_tx, d_tx, vgg_variables=v_vars,
        g_variables=g_vars, d_variables=d_vars)
    step = jax_make_train_step(*jstate.make_models(JCFG), g_tx, d_tx,
                               donate=False)
    state, _ = step(state, jax.tree.map(jnp.asarray, batches[0]),
                    jax.random.key(7))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "checkpoint_000.pt")
    jax_pt.save_reference_gan_checkpoint(
        path, _jax_variables(state, "generator"),
        _jax_variables(state, "discriminator"), state.g_opt_state,
        state.d_opt_state, lr=LR)
    state, metrics = step(state, jax.tree.map(jnp.asarray, batches[1]),
                          jax.random.key(7))
    after = {net: EXPORTS[net](_jax_variables(state, net)) for net in EXPORTS}
    return path, {k: float(metrics[k]) for k in METRICS}, after, v_vars, \
        batches[1]


def test_port_checkpoint_reads_in_jax_key_for_key(tmp_path):
    state = _trained_port_state(steps=2)
    path = save_checkpoint(str(tmp_path), state, step=4)
    assert os.path.basename(path) == "checkpoint_004.pt"
    g_vars, d_vars, g_mom, d_mom = jax_pt.load_reference_gan_checkpoint(
        path, include_optimizer=True)
    for net, variables, moments in (("generator", g_vars, g_mom),
                                    ("discriminator", d_vars, d_mom)):
        module = getattr(state, net)
        optimizer = getattr(state, f"{net[0]}_optimizer")
        want = module.state_dict()
        got = EXPORTS[net](variables)
        assert set(parameter_keys(got)) == set(parameter_keys(want))
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            assert torch.equal(got[key], value), key
        assert moments["count"] == 2 == state.step
        aux = {k: v for k, v in variables.items() if k != "params"}
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            exported = EXPORTS[net]({"params": moments[moment], **aux})
            for name, param in module.named_parameters():
                assert torch.equal(exported[name],
                                   optimizer.state[param][slot]), (net, name)


def test_jax_checkpoint_resumes_with_jax_next_update(jax_run):
    path, want_metrics, want, v_vars, batch = jax_run
    state = init_train_state(CFG, CPU, lr=LR, seed=3, vgg_variables=v_vars)
    restore_checkpoint(path, state)
    assert state.step == 1  # the reference layout's step: Adam's count
    _, metrics = make_train_step()(state, batch_to_device(batch, CPU))
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k],
                                   rtol=2e-3, atol=2e-5, err_msg=k)
    for net, share in (("generator", 1e-3), ("discriminator", 0.0)):
        got = getattr(state, net).state_dict()
        off = total = 0
        for key, w in want[net].items():
            err = (got[key] - w).abs()
            if key.endswith(("weight_u", "weight_v")):
                assert err.max() <= 1e-4, key
            elif key.endswith(("running_mean", "running_var")):
                assert bool((err <= 1e-6 + 3e-4 * w.abs()).all()), key
            elif not key.endswith("num_batches_tracked"):
                assert err.max() <= 4 * LR, key
                off += int((err > 1e-2 * LR + 2.0 ** -22 * w.abs()).sum())
                total += err.numel()
        assert off <= share * total, f"{net}: {off} of {total} elements off"


def test_adam_moments_map_by_key_not_position(jax_run):
    """The JAX writer's key order is not the port's parameters() order; a
    positional optimizer.load_state_dict would put each attention's gamma
    moment on another tensor. import_adam_moments puts every moment on the
    parameter its key names."""
    path = jax_run[0]
    ckpt = load_reference_gan_checkpoint(path)
    state = init_train_state(CFG, CPU, lr=LR, seed=4)
    for net in ("generator", "discriminator"):
        module = getattr(state, net)
        names = [n for n, _ in module.named_parameters()]
        file_keys = parameter_keys(ckpt[net])
        assert sorted(names) == sorted(file_keys) and names != file_keys
        slots = ckpt[f"{net}_optimizer"]["state"]
        optimizer = getattr(state, f"{net[0]}_optimizer")
        assert import_adam_moments(optimizer, module,
                                   ckpt[f"{net}_optimizer"], ckpt[net]) == 1
        params = dict(module.named_parameters())
        for pid, key in enumerate(file_keys):
            for slot in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(optimizer.state[params[key]][slot],
                                   slots[pid][slot]), (net, key)
        moved = [n for i, n in enumerate(names) if file_keys[i] != n]
        assert any(n.endswith("gamma") for n in moved)
    assert state.g_optimizer.param_groups[0]["lr"] == LR  # torch adopts it


def test_port_round_trip_is_bitwise_and_resets_eval_caches(tmp_path):
    """save -> restore into another state: G, D, Adam and step equal bitwise,
    and an eval generate after the restore reads the restored weights, not
    the cached ones of the state's earlier weights."""
    trained = _trained_port_state(seed=1, steps=2)
    path = save_checkpoint(str(tmp_path), trained, step=0)
    other = _trained_port_state(seed=2, steps=1)
    other.vgg.load_state_dict(trained.vgg.state_dict())  # not in the file
    batch = batch_to_device(_batches(JCFG, 1, seed=9)[0], CPU)
    args = (batch["images"], batch["masks"], batch["labels"], batch["noise_g"])
    other.generator.eval()
    make_generate_fn(other.generator, other.vgg)(*args)  # fills the caches
    restore_checkpoint(path, other)
    assert other.step == trained.step == 2
    for net in ("generator", "discriminator"):
        a, b = getattr(trained, net).state_dict(), getattr(other, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
        sa = getattr(trained, f"{net[0]}_optimizer").state_dict()
        sb = getattr(other, f"{net[0]}_optimizer").state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, slot in sa["state"].items():
            for k, v in slot.items():
                assert torch.equal(v, sb["state"][i][k]), (net, i, k)
    got = make_generate_fn(other.generator, other.vgg)(*args)
    trained.generator.eval()
    want = make_generate_fn(trained.generator, trained.vgg)(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_latest_checkpoint_sorts_by_number(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("checkpoint_999.pt", "checkpoint_1000.pt", "checkpoint_002.pt",
                 "checkpoint_5000", "other.pt", "checkpoint_x.pt"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                   "checkpoint_1000.pt")


def test_restore_refuses_what_is_not_a_pt(tmp_path):
    state = init_train_state(CFG, CPU, seed=5)
    with pytest.raises(ValueError, match="convert_checkpoint"):
        restore_checkpoint(str(tmp_path / "checkpoint_000"), state)
