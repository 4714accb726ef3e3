"""The discriminator and the training-mode layers against the JAX package's
flax modules at tiny widths.

Weights come from the port's seeded init with spectral u/v advanced 10
power iterations (sigma near the spectral norm, activations O(1)), carried
into flax variables by the JAX package's `convert_discriminator_state_dict`;
the port's own bridge (`discriminator_state_dict_from_flax`) is held
against the JAX package's export. Inputs are numpy arrays from a seed.

Tolerances: fp32 runs full fp32 on both sides (JAX at HIGHEST precision,
torch on the CPU), so differences are summation order only: 1e-5 of the
largest output, 1e-5 absolute on u/v and running statistics, 1e-5 relative
on sigma and its gradient. bf16 rounds at other places in the two
frameworks (bias adds, the folded pool's kernel cast, the attention's p),
through seven blocks: 5% of the largest output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.models import layers as jl
from semantic_pyramid_for_image_generation_tpu.models.discriminator import (
    Discriminator as JaxDiscriminator,
)
from semantic_pyramid_for_image_generation_tpu.ops import spectral_norm as jsn
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    export_discriminator_state_dict,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models import (
    make_discriminator,
)
from semantic_pyramid_for_image_generation_torch.models.discriminator import (
    Discriminator,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    BatchNorm,
    ConditionalBatchNorm,
    SNConv2d,
    SNEmbedding,
    SNLinear,
    advance_spectral_norm_,
    fold_avg_pool,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import avg_pool_2d
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    discriminator_state_dict_from_flax,
)

CFG = PyramidGANConfig().tiny()
JCFG = JaxConfig().tiny()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def d_state():
    d = make_discriminator(CFG, CPU, torch.Generator().manual_seed(0))
    advance_spectral_norm_(d, 10)
    return {k: v.clone() for k, v in d.state_dict().items()}


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _uv(sd):
    return {k: v for k, v in sd.items() if k.endswith(("weight_u", "weight_v"))}


def test_discriminator_parameter_count_at_full_width():
    with torch.device("meta"):
        d = Discriminator(PyramidGANConfig())
    assert sum(p.numel() for p in d.parameters()) == 16_820_994


def test_discriminator_bridge_matches_jax_export(d_state):
    variables = convert_discriminator_state_dict(d_state)
    exported = export_discriminator_state_dict(variables)  # reference layout
    bridged = discriminator_state_dict_from_flax(variables)
    assert set(bridged) == set(exported) == set(d_state)
    for key in exported:
        torch.testing.assert_close(bridged[key], exported[key], rtol=0, atol=0)
        torch.testing.assert_close(bridged[key], d_state[key], rtol=0, atol=0)
    Discriminator(CFG).load_state_dict(exported, strict=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_flax(d_state, train, compat, dtype):
    """Eval mode reuses u/v; training mode advances them once per layer
    (compared after the forward). bf16 folds each block's pool into its
    conv on both sides."""
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (3, 256, 256, 3)).astype(np.float32)
    onehot = np.eye(CFG.num_classes, dtype=np.float32)[[2, 7, 2]]
    jcfg = dataclasses.replace(JCFG, compat_projection=compat,
                               compute_dtype=dtype)
    variables = convert_discriminator_state_dict(d_state)
    variables.pop("batch_stats")
    out = JaxDiscriminator(jcfg).apply(
        variables, jnp.asarray(images), jnp.asarray(onehot), train=train,
        mutable=["spectral"] if train else False)
    want, new_vars = out if train else (out, None)
    want = np.asarray(want).astype(np.float32)
    cfg = dataclasses.replace(CFG, compat_projection=compat,
                              compute_dtype=dtype)
    d = make_discriminator(cfg, CPU)
    d.load_state_dict(d_state, strict=True)
    d.train(train)
    with torch.no_grad():
        got = d(_nchw(images), torch.from_numpy(onehot)).float().numpy()
    assert got.shape == want.shape == ((3, 3, 128) if compat else (3, 1))
    scale = float(np.abs(want).max())
    atol = 1e-5 * max(scale, 1.0) if dtype == "float32" else 0.05 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if train:
        new = export_discriminator_state_dict(
            dict(variables, spectral=new_vars["spectral"]))
        got_uv = _uv(d.state_dict())
        for key, value in _uv(new).items():
            torch.testing.assert_close(got_uv[key], value, rtol=0, atol=1e-5,
                                       msg=key)
        assert sum(not torch.equal(got_uv[k], d_state[k]) for k in got_uv) > 10


def test_folded_avg_pool_equals_conv_then_pool():
    """The bf16 fold, checked in fp32: one stride-2 conv of the folded
    kernel equals avg_pool_2x2(conv(x)) for a 3x3 (padding 1) and a 1x1
    kernel."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 8, 8, generator=g)
    for k, pad in ((3, 1), (1, 0)):
        w = torch.randn(6, 5, k, k, generator=g)
        want = avg_pool_2d(F.conv2d(x, w, padding=pad))
        got = F.conv2d(x, fold_avg_pool(w), stride=2, padding=pad)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------ spectral norm layers -----


def _flax_sn_conv_variables(layer: SNConv2d):
    w = layer.weight_orig.detach().numpy()
    return {"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)),
                       "bias": jnp.asarray(layer.bias.detach().numpy())},
            "spectral": {"u": jnp.asarray(layer.weight_u.numpy()),
                         "v": jnp.asarray(layer.weight_v.numpy())}}


def test_sn_conv_training_forwards_match_jax():
    """Three training forwards: u, v, sigma and the output after each, and
    the gradient through sigma (d sigma / dW = u v^T, u/v constant)."""
    torch.manual_seed(3)
    layer = SNConv2d(6, 8, 3, padding=1)
    layer.train()
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 6)).astype(
        np.float32)
    variables = _flax_sn_conv_variables(layer)
    module = jl.SNConv(8, kernel_size=(3, 3), padding=1)
    for _ in range(3):
        want, mutated = module.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["spectral"])
        variables = {"params": variables["params"], **mutated}
        got = layer(_nchw(x))
        np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(layer.weight_u.numpy(),
                                   np.asarray(mutated["spectral"]["u"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(layer.weight_v.numpy(),
                                   np.asarray(mutated["spectral"]["v"]),
                                   rtol=0, atol=1e-5)

    def jax_loss(params):
        y, _ = module.apply({"params": params, **mutated}, jnp.asarray(x),
                            train=True, mutable=["spectral"])
        return jnp.sum(y * y)

    want_grad = jax.grad(jax_loss)(variables["params"])["kernel"]
    u, v = layer.weight_u.clone(), layer.weight_v.clone()
    layer.weight_u, layer.weight_v = (
        torch.from_numpy(np.array(variables["spectral"][k]))
        for k in ("u", "v"))
    loss = layer(_nchw(x)).square().sum()
    (grad,) = torch.autograd.grad(loss, layer.weight_orig)
    np.testing.assert_allclose(grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(want_grad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_grad).max()))
    assert not torch.equal(u, layer.weight_u) or not torch.equal(
        v, layer.weight_v)


def test_sn_linear_sigma_after_each_training_forward_matches_jax():
    """sigma (W / normalized W), u and v after each of 4 training forwards
    against JAX `spectral_norm_weight(update=True)` chained as often."""
    torch.manual_seed(6)
    layer = SNLinear(40, 24)
    layer.train()
    w = jnp.asarray(layer.weight_orig.detach().numpy())
    u, v = (jnp.asarray(b.numpy()) for b in (layer.weight_u, layer.weight_v))
    for _ in range(4):
        sigma, u, v = jsn.spectral_norm_weight(w, u, v, update=True)
        normalized = layer.normalized_weight().detach()
        got = (layer.weight_orig.detach() / normalized).mean()
        np.testing.assert_allclose(float(got), float(sigma), rtol=1e-5)
        np.testing.assert_allclose(layer.weight_u.numpy(), np.asarray(u),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(layer.weight_v.numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6)


def test_sn_layer_rebinds_u_and_v_so_two_forwards_share_one_backward():
    """Discriminator-style: two training forwards, then one backward. The
    first forward's sigma keeps its own u/v; writing the second update into
    the same buffers would make autograd raise."""
    torch.manual_seed(4)
    layer = SNConv2d(3, 4, 3)
    layer.train()
    x = torch.randn(2, 3, 8, 8)
    u0 = layer.weight_u
    loss = layer(x).sum() + layer(x).square().sum()
    loss.backward()
    assert layer.weight_u is not u0
    assert layer.weight_orig.grad is not None


def test_sn_embedding_training_forward_matches_jax():
    torch.manual_seed(5)
    layer = SNEmbedding(16, 12)
    layer.train()
    idx = np.array([[3], [0], [3]])
    variables = {"params": {"embedding": jnp.asarray(
        layer.weight_orig.detach().numpy())},
        "spectral": {"u": jnp.asarray(layer.weight_u.numpy()),
                     "v": jnp.asarray(layer.weight_v.numpy())}}
    want, mutated = jl.SNEmbedding(16, 12).apply(
        variables, jnp.asarray(idx), train=True, mutable=["spectral"])
    got = layer(torch.from_numpy(idx[:, 0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(layer.weight_u.numpy(),
                               np.asarray(mutated["spectral"]["u"]), rtol=0,
                               atol=1e-6)


# ------------------------------------------------- batch norm, training ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conditional_batch_norm_training_matches_flax(dtype):
    """Batch statistics by E[x^2] - E[x]^2 in fp32; two forwards advance
    the running mean and the unbiased running var (momentum 0.001)."""
    rng = np.random.default_rng(6)
    c, classes = 8, 5
    cbn = ConditionalBatchNorm(c, classes)
    with torch.no_grad():
        cbn.embedding.weight.add_(0.2 * torch.from_numpy(
            rng.standard_normal((classes, 2 * c)).astype(np.float32)))
        cbn.batch_norm.running_mean.copy_(torch.from_numpy(
            rng.standard_normal(c).astype(np.float32)))
    cbn.train()
    variables = {
        "params": {"embedding": jnp.asarray(
            cbn.embedding.weight.detach().numpy())},
        "batch_stats": {"mean": jnp.asarray(cbn.batch_norm.running_mean.numpy()),
                        "var": jnp.asarray(cbn.batch_norm.running_var.numpy())}}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    module = jl.ConditionalBatchNorm(c, classes, dtype=jdt)
    onehot = np.eye(classes, dtype=np.float32)[[1, 4, 1]]
    for _ in range(2):
        x = (2.0 + 3.0 * rng.standard_normal((3, 4, 4, c))).astype(np.float32)
        want, mutated = module.apply(variables, jnp.asarray(x, jdt),
                                     jnp.asarray(onehot), train=True,
                                     mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = cbn(_nchw(x, tdt), torch.from_numpy(onehot))
        want = np.asarray(want).astype(np.float32)
        atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(_nhwc(got.detach()), want, rtol=0,
                                   atol=atol)
        for name, buf in (("mean", cbn.batch_norm.running_mean),
                          ("var", cbn.batch_norm.running_var)):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(mutated["batch_stats"][name]),
                rtol=1e-6, atol=1e-7, err_msg=name)


def test_batch_norm_training_matches_flax():
    rng = np.random.default_rng(7)
    c = 6
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(1 + 0.3 * rng.standard_normal(c)))
        bn.bias.copy_(torch.from_numpy(0.3 * rng.standard_normal(c)))
    bn.train()
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    x = (1.0 + 2.0 * rng.standard_normal((2, 8, 8, c))).astype(np.float32)
    want, mutated = jl.BatchNorm(c).apply(variables, jnp.asarray(x),
                                          train=True, mutable=["batch_stats"])
    xt = _nchw(x).requires_grad_(True)
    got = bn(xt)
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jl.BatchNorm(c).apply(
        variables, t, train=True, mutable=["batch_stats"])[0], jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    got.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_grad), rtol=0,
                               atol=1e-5)
