"""The gradients of the train step's two phases against `jax.grad` of the
JAX package's losses, per parameter tensor, before any optimizer.

The post-update parameters of tests/test_torch_train_step.py go through
Adam, which divides each gradient element by its own magnitude; this file
holds the gradients themselves. Both sides start from one state (the
port's seeded init, u/v advanced 10 power iterations, carried into flax
variables by the JAX package's converters) and one numpy batch with pinned
latents, and run each phase's networks in training mode (one power
iteration per layer per forward, batch statistics), as the step does.

Tolerance, fp32: per tensor, 1e-4 of the tensor's largest gradient plus
1e-5 of the network's largest gradient. The second term is the fp32 noise
floor: batch statistics remove every bias that feeds a training-mode batch
norm, so those gradients are zero in exact arithmetic and read ~1e-7 in
both frameworks against a largest gradient of ~0.3 (at these inputs); the batch
moments are fp32 sums over up to B*H*W = 131072 elements.
"""

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
from semantic_pyramid_for_image_generation_tpu.ops.spectral_norm import (
    compute_sigma_tree,
)
from semantic_pyramid_for_image_generation_tpu.train import losses as jlosses
from semantic_pyramid_for_image_generation_tpu.train import state as jstate
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    convert_generator_state_dict,
    convert_vgg16_state_dict,
    export_discriminator_state_dict,
    export_generator_state_dict,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.train import losses as tlosses
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
)

CFG = PyramidGANConfig().tiny()
JCFG = JaxConfig().tiny()
CPU = torch.device("cpu")
W_REC = W_DIV = 0.1


@pytest.fixture(scope="module")
def setup():
    state = init_train_state(CFG, CPU, seed=3)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)
    variables = (convert_generator_state_dict(state.generator.state_dict()),
                 convert_discriminator_state_dict(
                     state.discriminator.state_dict()),
                 convert_vgg16_state_dict(state.vgg.state_dict()))
    rng = np.random.default_rng(8)
    batch = jax_synthetic_batch(JCFG, 2, rng)
    batch["noise"] = rng.standard_normal((2, JCFG.latent_dim)).astype(
        np.float32)
    # the D phase's fakes: any images in [-1, 1] (G runs without gradients)
    batch["fake"] = np.tanh(rng.standard_normal((2, 256, 256, 3))).astype(
        np.float32)
    return variables, batch


def _port_state(variables):
    """A fresh port state from the variables: each test advances its own."""
    g_vars, d_vars, v_vars = variables
    return init_train_state(CFG, CPU, g_variables=g_vars, d_variables=d_vars,
                            vgg_variables=v_vars)


def _port_batch(batch):
    tb = batch_to_device(batch, CPU)
    images = tb["images"].permute(0, 3, 1, 2)
    masks = [m.permute(0, 3, 1, 2) if m.dim() == 4 else m for m in tb["masks"]]
    return tb, images, masks


def _assert_gradients_match(module, want_sd):
    grads = {k: p.grad for k, p in module.named_parameters()}
    assert all(g is not None for g in grads.values())
    net_max = max(float(want_sd[k].abs().max()) for k in grads)
    for key, got in grads.items():
        want = want_sd[key]
        atol = 1e-4 * float(want.abs().max()) + 1e-5 * net_max
        torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=key)


def test_generator_phase_gradients_match_jax(setup):
    variables, batch = setup
    g_vars, d_vars, v_vars = variables
    state = _port_state(variables)
    generator, discriminator, vgg = jstate.make_models(JCFG)
    jb = jax.tree.map(jnp.asarray, batch)
    masks = list(jb["masks"])
    features = vgg.apply({"params": v_vars["params"]}, jb["images"])

    def g_loss(g_params):
        sigmas, _ = compute_sigma_tree(g_params, g_vars["spectral"], True)
        fake, _ = generator.apply(
            {"params": g_params, "spectral": g_vars["spectral"],
             "batch_stats": g_vars["batch_stats"], "sigmas": sigmas},
            jb["noise"], features, masks, jb["labels"], train=True,
            mutable=["batch_stats"])
        d_sigmas, _ = compute_sigma_tree(d_vars["params"], d_vars["spectral"],
                                         True)
        pred = discriminator.apply(
            {"params": d_vars["params"], "spectral": d_vars["spectral"],
             "sigmas": d_sigmas}, fake, jb["labels"], train=True)
        rec = jlosses.semantic_reconstruction_loss(
            features, vgg.apply({"params": v_vars["params"]}, fake), masks)
        return (jlosses.lsgan_generator_loss(pred)
                + W_DIV * jlosses.diversity_loss(fake, jb["noise"])
                + W_REC * rec)

    want_loss, grads = jax.jit(jax.value_and_grad(g_loss))(g_vars["params"])
    want = export_generator_state_dict(dict(g_vars, params=grads))

    tb, images, masks = _port_batch(batch)
    with torch.no_grad():
        tfeatures = state.vgg(images)
    fake = state.generator(tb["noise"], tfeatures, masks, tb["labels"])
    loss = (tlosses.lsgan_generator_loss(
        state.discriminator(fake, tb["labels"]))
        + W_DIV * tlosses.diversity_loss(fake, tb["noise"])
        + W_REC * tlosses.semantic_reconstruction_loss(
            tfeatures, state.vgg(fake), masks))
    loss.backward(inputs=list(state.generator.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_gradients_match(state.generator, want)


def test_discriminator_phase_gradients_match_jax(setup):
    """D on real, then on fake (two power iterations), the LSGAN D loss."""
    variables, batch = setup
    d_vars = variables[1]
    state = _port_state(variables)
    _, discriminator, _ = jstate.make_models(JCFG)
    jb = jax.tree.map(jnp.asarray, batch)

    def d_loss(d_params):
        sig_1, spec_1 = compute_sigma_tree(d_params, d_vars["spectral"], True)
        real = discriminator.apply(
            {"params": d_params, "spectral": d_vars["spectral"],
             "sigmas": sig_1}, jb["images"], jb["labels"], train=True)
        sig_2, _ = compute_sigma_tree(d_params, spec_1, True)
        fake = discriminator.apply(
            {"params": d_params, "spectral": spec_1, "sigmas": sig_2},
            jb["fake"], jb["labels"], train=True)
        loss_real, loss_fake = jlosses.lsgan_discriminator_loss(real, fake)
        return loss_real + loss_fake

    want_loss, grads = jax.jit(jax.value_and_grad(d_loss))(d_vars["params"])
    want = export_discriminator_state_dict(dict(d_vars, params=grads))

    tb, images, _ = _port_batch(batch)
    d = state.discriminator
    loss_real, loss_fake = tlosses.lsgan_discriminator_loss(
        d(images, tb["labels"]), d(tb["fake"].permute(0, 3, 1, 2),
                                   tb["labels"]))
    loss = loss_real + loss_fake
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_gradients_match(d, want)
