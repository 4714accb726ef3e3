"""The port's modules against the JAX package's flax modules at tiny widths.

Weights come from a flax init, made non-trivial (random batch statistics
and class tables, spectral u/v advanced to near-convergence so sigma is the
real spectral norm and activations stay O(1)), then cross the weight bridge
into the port. Inputs are numpy arrays from a seed, fed to both frameworks.

Tolerances: fp32 runs full fp32 on both sides (JAX at HIGHEST precision,
torch on the CPU), so the differences are summation order only: 1e-5
absolute for O(1) activations, relative 1e-5 for the VGG pyramid whose
activations grow with depth. bf16 rounds at other places in the two
frameworks (conv bias add, the residual commute's upsample), so bf16 is held
in a band of a few bf16 ulps of the largest output.
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
from semantic_pyramid_for_image_generation_tpu.models import layers as jl
from semantic_pyramid_for_image_generation_tpu.models.generator import (
    Generator as JaxGenerator,
)
from semantic_pyramid_for_image_generation_tpu.models.vgg16 import (
    VGG16 as JaxVGG16,
)
from semantic_pyramid_for_image_generation_tpu.ops import spectral_norm as jsn
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    export_generator_state_dict,
    export_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.ops import spectral_norm as tsn
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_state_dict_from_flax,
    vgg16_state_dict_from_flax,
    vgg16_state_dict_from_torch,
)

CFG = PyramidGANConfig().tiny()
JCFG = JaxConfig().tiny()
CPU = torch.device("cpu")


def realistic_generator_variables(variables, seed=0):
    """A flax Generator init with random BN statistics, CBN tables, final-BN
    affine and gamma, and u/v advanced 20 power iterations."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        names = [p.key for p in path]
        x = np.array(x, np.float32)
        if names[-1] == "embedding" and names[-2].startswith("cbn_"):
            c = x.shape[1] // 2
            x[:, :c] = 1.0 + 0.2 * rng.standard_normal(x[:, :c].shape)
            x[:, c:] = 0.2 * rng.standard_normal(x[:, c:].shape)
        elif names[-1] == "gamma":
            x[...] = 0.7
        elif names[-2] == "final_bn" and names[-1] in ("scale", "bias"):
            x += 0.2 * rng.standard_normal(x.shape)
        elif names[-1] == "mean":
            x[...] = 0.2 * rng.standard_normal(x.shape)
        elif names[-1] == "var":
            x[...] = rng.uniform(0.5, 1.5, x.shape)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    spectral = variables["spectral"]
    for _ in range(20):
        _, spectral = jsn.compute_sigma_tree(params, spectral, update=True)
    spectral = jax.tree.map(lambda x: np.array(x, np.float32), spectral)
    return {"params": params, "spectral": spectral, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_variables():
    feats = [jnp.zeros((1,) + s, jnp.float32) for s in JCFG.feature_shapes]
    masks = [jnp.zeros((1,) + s, jnp.float32) for s in JCFG.mask_shapes]
    onehot = jnp.zeros((1, JCFG.num_classes), jnp.float32)
    g_vars = JaxGenerator(JCFG).init(
        jax.random.key(0), jnp.zeros((1, JCFG.latent_dim)), feats, masks,
        onehot, train=False)
    vgg_vars = JaxVGG16(JCFG).init(
        jax.random.key(1), jnp.zeros((1, 256, 256, 3), jnp.float32))
    return (realistic_generator_variables(g_vars),
            jax.tree.map(np.asarray, vgg_vars))


def _port_generator(g_vars, cfg=CFG):
    g = Generator(cfg)
    g.load_state_dict(generator_state_dict_from_flax(g_vars), strict=True)
    return g.to(memory_format=torch.channels_last).eval()


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _sub(tree, key):
    return {k: v[key] for k, v in tree.items() if key in v}


# ---------------------------------------------------------------- (f) -----


def test_full_width_generator_parameter_count():
    with torch.device("meta"):
        g = Generator(PyramidGANConfig())
    assert sum(p.numel() for p in g.parameters()) == 29_967_047


def test_generator_strict_load_of_exported_state_dict(jax_variables):
    g_vars, _ = jax_variables
    exported = export_generator_state_dict(g_vars)  # the reference layout
    bridged = generator_state_dict_from_flax(g_vars)
    assert set(exported) == set(bridged)
    for key in exported:
        torch.testing.assert_close(bridged[key], exported[key], rtol=0, atol=0)
    g = Generator(CFG)
    g.load_state_dict(exported, strict=True)
    assert set(g.state_dict()) == set(exported)


def test_vgg_strict_load_of_exported_state_dict(jax_variables):
    _, vgg_vars = jax_variables
    exported = export_vgg16_state_dict(vgg_vars)  # `vgg16.` prefix
    bridged = vgg16_state_dict_from_flax(vgg_vars)
    vgg = VGG16(CFG)
    vgg.load_state_dict(exported, strict=True)
    vgg.load_state_dict(bridged, strict=True)
    bare = {k[len("vgg16."):]: v for k, v in exported.items()}
    vgg.load_state_dict(vgg16_state_dict_from_torch(bare), strict=True)


def test_make_models_seeded_init_is_deterministic():
    g1, v1 = make_models(CFG, CPU, torch.Generator().manual_seed(3))
    g2, v2 = make_models(CFG, CPU, torch.Generator().manual_seed(3))
    for a, b in ((g1, g2), (v1, v2)):
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    cbn = g1.main_path[0].main_block[0].embedding.weight
    assert torch.equal(cbn[:, :cbn.shape[1] // 2], torch.ones_like(cbn[:, :1]).
                       expand(-1, cbn.shape[1] // 2))
    u = g1.linear_layer.weight_u
    torch.testing.assert_close(torch.linalg.vector_norm(u), torch.tensor(1.0))


# ------------------------------------------------------ spectral norm -----


@pytest.mark.parametrize("update", [False, True])
def test_spectral_norm_weight_matches_jax(update):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 72)).astype(np.float32)
    u = rng.standard_normal(16).astype(np.float32)
    v = rng.standard_normal(72).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    want = jsn.spectral_norm_weight(jnp.asarray(w), jnp.asarray(u),
                                    jnp.asarray(v), update=update)
    got = tsn.spectral_norm_weight(torch.from_numpy(w), torch.from_numpy(u),
                                   torch.from_numpy(v), update=update)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_advance_spectral_norm_matches_jax_sigma_pass(jax_variables):
    """Three power iterations on every G layer == three update=True passes
    of the JAX batched sigma pass, on u and v (fp32, order-only rounding)."""
    g_vars, _ = jax_variables
    spectral = g_vars["spectral"]
    for _ in range(3):
        _, spectral = jsn.compute_sigma_tree(g_vars["params"], spectral,
                                             update=True)
    want = generator_state_dict_from_flax(dict(g_vars, spectral=jax.tree.map(
        np.asarray, spectral)))
    g = _port_generator(g_vars)
    advance_spectral_norm_(g, 3)
    got = g.state_dict()
    keys = [k for k in want if k.endswith(("weight_u", "weight_v"))]
    assert len(keys) == 2 * 32  # every SN layer of G
    for key in keys:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5,
                                   msg=key)


# ---------------------------------------------------------------- (b) -----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conditional_batch_norm_eval_matches_flax(jax_variables, dtype):
    g_vars, _ = jax_variables
    v = _sub(_sub(g_vars, "block_1"), "cbn_2")
    c = v["params"]["embedding"].shape[1] // 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 8, c)).astype(np.float32)
    onehot = np.eye(CFG.num_classes, dtype=np.float32)[[0, 5, 11]]
    jdt = jnp.dtype(dtype)
    want = jl.ConditionalBatchNorm(c, CFG.num_classes, dtype=jdt).apply(
        v, jnp.asarray(x, jdt), jnp.asarray(onehot), train=False)
    port = _port_generator(g_vars).main_path[1].main_block[4]
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x, getattr(torch, dtype)),
                         torch.from_numpy(onehot)))
    want = np.asarray(want).astype(np.float32)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_matches_flax(jax_variables, dtype):
    g_vars, _ = jax_variables
    v = _sub(g_vars, "self_attention")
    c = CFG.generator_attention_channels
    x = np.random.default_rng(2).standard_normal((2, 32, 32, c)).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jl.SelfAttention(c, use_pallas=True, dtype=jdt).apply(
        v, jnp.asarray(x, jdt), train=False)).astype(np.float32)
    port = _port_generator(g_vars).main_path[3]
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x, getattr(torch, dtype)).contiguous(
            memory_format=torch.channels_last)))
    atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_residual_block_matches_flax(jax_variables, dtype):
    """Block 3 (64 -> 32 channels at tiny, 16x16 -> 32x32); in bf16 both sides
    take the residual commute up2(conv1x1(x))."""
    g_vars, _ = jax_variables
    v = _sub(g_vars, "block_3")
    (cin, cout) = CFG.generator_block_channels[3]
    cf = CFG.vgg_conv_channels[1]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    feat = rng.standard_normal((2, 32, 32, cf)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    onehot = np.eye(CFG.num_classes, dtype=np.float32)[[2, 9]]
    jdt = jnp.dtype(dtype)
    want = np.asarray(jl.GeneratorResidualBlock(
        cin, cout, CFG.num_classes, dtype=jdt).apply(
        v, jnp.asarray(x, jdt),
        (jnp.asarray(feat * mask, jdt), jnp.asarray(mask, jdt)),
        jnp.asarray(onehot), train=False)).astype(np.float32)
    port = _port_generator(g_vars).main_path[4]
    tdt = getattr(torch, dtype)
    masked = torch.cat([_nchw(feat * mask, tdt), _nchw(mask, tdt)], dim=1)
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x, tdt).contiguous(
            memory_format=torch.channels_last), masked,
            torch.from_numpy(onehot)))
    atol = 2e-5 if dtype == "float32" else 4 * 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------- (c) -----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_pyramid_matches_jax(jax_variables, dtype):
    _, vgg_vars = jax_variables
    images = np.random.default_rng(4).uniform(
        -1, 1, (2, 256, 256, 3)).astype(np.float32)
    jcfg = dataclasses.replace(JCFG, compute_dtype=dtype)
    want = JaxVGG16(jcfg).apply(vgg_vars, jnp.asarray(images))
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    vgg = VGG16(cfg)
    vgg.load_state_dict(vgg16_state_dict_from_flax(vgg_vars), strict=True)
    vgg = vgg.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        got = vgg(_nchw(images))
    assert len(got) == 7
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).astype(np.float32)
        g = _nhwc(g) if g.dim() == 4 else g.float().numpy()
        assert g.shape == w.shape, level
        scale = np.abs(w).max()
        tol = 1e-5 * scale if dtype == "float32" else 0.05 * scale
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"level {level}")
