"""The whole slice: the port's generate against the JAX package's
`make_generate_fn` (with the Pallas attention kernel, interpret mode on the
CPU) on the same weights, images, masks, labels and noise, at all 7 mask
levels, in fp32 and in bf16.

Weights: JAX `init_train_state` at tiny widths, made non-trivial as in
test_torch_models.py, then the weight bridge into the port.

Tolerances: fp32 is the parity mode; both sides run full fp32 and differ in
summation order only, held at 5e-6 absolute on the tanh output (5.7e-7
observed at these inputs). bf16 rounds at other places in the two frameworks
(conv bias add, where the upsample rounds) and the differences grow through
~20 layers, so bf16 is a band: 0.05 absolute (0.012 observed) and a mean
absolute difference below 0.005 (0.001 observed).
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
from semantic_pyramid_for_image_generation_tpu.train.state import (
    init_train_state,
    make_models as jax_make_models,
    make_optimizers,
)
from semantic_pyramid_for_image_generation_tpu.train.step import (
    ensure_m11_images as jax_ensure_m11_images,
    make_generate_fn as jax_make_generate_fn,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
from semantic_pyramid_for_image_generation_torch.train.step import (
    ensure_m11_images,
    make_generate_fn,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_state_dict_from_flax,
    vgg16_state_dict_from_flax,
)
from test_torch_models import realistic_generator_variables

CFG = PyramidGANConfig().tiny()
JCFG = JaxConfig().tiny()
BATCH = 2


@pytest.fixture(scope="module")
def setup():
    g_tx, d_tx = make_optimizers()
    state = init_train_state(jax.random.key(0), JCFG, g_tx, d_tx)
    g_vars = realistic_generator_variables(
        {"params": state.g_params, "spectral": state.g_spectral,
         "batch_stats": state.g_batch_stats})
    as_jnp = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    state = state.replace(g_params=as_jnp(g_vars["params"]),
                          g_spectral=as_jnp(g_vars["spectral"]),
                          g_batch_stats=as_jnp(g_vars["batch_stats"]))
    vgg_params = jax.tree.map(np.asarray, state.vgg_params)

    rng = np.random.default_rng(5)
    inputs = {
        "images": rng.uniform(-1, 1, (BATCH, 256, 256, 3)).astype(np.float32),
        "labels": np.eye(CFG.num_classes, dtype=np.float32)[[3, 12]],
        "noise": rng.standard_normal((BATCH, CFG.latent_dim)).astype(np.float32),
    }
    fns = {}
    for dtype in ("float32", "bfloat16"):
        generator, _, vgg = jax_make_models(
            dataclasses.replace(JCFG, compute_dtype=dtype),
            use_pallas_attention=True)
        g, v = make_models(dataclasses.replace(CFG, compute_dtype=dtype),
                           torch.device("cpu"))
        g.load_state_dict(generator_state_dict_from_flax(g_vars), strict=True)
        v.load_state_dict(vgg16_state_dict_from_flax(vgg_params), strict=True)
        fns[dtype] = (jax_make_generate_fn(generator, vgg),
                      make_generate_fn(g, v))
    return state, inputs, fns


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", range(7))
def test_generate_matches_jax(setup, level, dtype):
    state, inputs, fns = setup
    jax_fn, port_fn = fns[dtype]
    schedule = MaskSchedule(CFG)
    masks = schedule.batch([schedule.inference_masks(level)] * BATCH)
    want = np.asarray(jax_fn(
        state, jnp.asarray(inputs["images"]),
        tuple(jnp.asarray(m) for m in masks), jnp.asarray(inputs["labels"]),
        jax.random.key(0), noise=jnp.asarray(inputs["noise"]))
    ).astype(np.float32)
    kernels.reset_launch_counts()
    got = port_fn(torch.from_numpy(inputs["images"]),
                  [torch.from_numpy(m) for m in masks],
                  torch.from_numpy(inputs["labels"]),
                  torch.from_numpy(inputs["noise"]))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == (BATCH, 256, 256, 3)
    assert np.isfinite(got).all()
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain versions
    # the comparison means something only if the output is not saturated
    assert np.abs(want).max() < 0.999
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
        assert np.abs(got - want).mean() < 0.005


def test_ensure_m11_images_matches_jax():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    u8[1] = 7  # a constant image: max - min = 0
    want = np.asarray(jax_ensure_m11_images(jnp.asarray(u8)))
    got = ensure_m11_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    floats = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 4, 3)))
    assert ensure_m11_images(floats) is floats
