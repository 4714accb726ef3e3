"""The training slice's ops against the JAX package: the backward kernels'
plain versions (Kernels 4 and 5), the attention Function's gradients, the
pools the JAX package leaves to XLA, and the four losses.

On the CPU each wrapper runs its plain version; those are held against
`jax.vjp` of the JAX package's functions: the Pallas kernels in interpret
mode, as tests/test_pallas_*.py run them, and the XLA forms the JAX train
step takes on the CPU (ops/pool.py::max_pool_2d, ops/resize.py::
upsample_bilinear_align_corners). Inputs are numpy arrays from a seed.

Tolerances:
  * max-pool backward: bitwise in fp32 and bf16, on tie-heavy inputs
    (ReLU'd and quantized to quarters, and 0/1 masks with C = 1). Both sides
    route g by the balanced rule, whose g/2 and g/4 are exact.
  * upsample backward fp32: 2e-6 absolute (both sides are fp32 sums of a
    few weighted terms of O(1) values, in another order); bf16: two bf16
    ulps of max |gx| (both round between the two passes, in another order).
  * attention gradients fp32: 1e-5 of the largest gradient entry (the same
    fp32 recompute of p, another summation order; N(0, 1) inputs of width
    32 give logits up to ~25, whose rounding exp carries into p, and
    gradients up to ~10).
  * pools and losses fp32: 1e-6 absolute / 1e-5 relative (means and sums in
    another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.ops import pool as jpool
from semantic_pyramid_for_image_generation_tpu.ops.pallas.attention import (
    pooled_kv_attention as jax_attention,
)
from semantic_pyramid_for_image_generation_tpu.ops.pallas.pool import (
    max_pool_2x2_pallas,
)
from semantic_pyramid_for_image_generation_tpu.ops.pallas.resize import (
    upsample_align_corners_pallas,
)
from semantic_pyramid_for_image_generation_tpu.ops.resize import (
    upsample_bilinear_align_corners as jax_upsample,
)
from semantic_pyramid_for_image_generation_tpu.train import losses as jlosses
from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
from semantic_pyramid_for_image_generation_torch.ops import pool as tpool
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    PooledKVAttentionFunction,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.pool import (
    max_pool_2x2_backward,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    upsample_2x_backward,
)
from semantic_pyramid_for_image_generation_torch.train import losses as tlosses

DTYPES = ["float32", "bfloat16"]


def _nchw(x: np.ndarray, dtype: str = "float32") -> torch.Tensor:
    """NHWC numpy -> the NCHW channels_last view the port's ops take."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _bits(a: np.ndarray, dtype: str) -> np.ndarray:
    """Bit patterns, so -0.0 and 0.0 differ only where both sides agree."""
    if dtype == "bfloat16":
        return np.asarray(a).astype(np.float32).view(np.int32) >> 16
    return np.asarray(a, np.float32).view(np.int32)


def _tie_heavy(rng, shape) -> np.ndarray:
    x = np.maximum(rng.standard_normal(shape), 0.0)
    return np.minimum(np.round(x * 4) / 4, 1.5).astype(np.float32)


# ------------------------------------------------------------ Kernel 4 -----


MAX_POOL_SHAPES = [(2, 16, 16, 8), (1, 32, 32, 64), (2, 8, 12, 3),
                   (2, 128, 128, 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MAX_POOL_SHAPES + [(3, 32, 32, 1)])
@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_max_pool_backward_plain_bitwise_vs_jax_vjp(shape, dtype, reference):
    rng = np.random.default_rng(0)
    if shape[-1] == 1:  # a 0/1 mask: ties in nearly every window
        x = (rng.random(shape) < 0.5).astype(np.float32)
    else:
        x = _tie_heavy(rng, shape)
    b, h, w, c = shape
    g = rng.standard_normal((b, h // 2, w // 2, c)).astype(np.float32)
    fn = (max_pool_2x2_pallas if reference == "pallas"
          else lambda t: jpool.max_pool_2d(t, 2))
    _, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
    (want,) = vjp(jnp.asarray(g, dtype))
    got = max_pool_2x2_backward(
        _nchw(x, dtype).contiguous(memory_format=torch.channels_last),
        _nchw(g, dtype))
    np.testing.assert_array_equal(_bits(_nhwc(got), dtype),
                                  _bits(np.asarray(want), dtype))


def test_max_pool_function_routes_ties_like_jax():
    """Through autograd (MaxPool2x2Function), a 2x2 window of four equal
    values gives g/4 to each, a tie of two g/2 to each."""
    x = torch.tensor([[1.0, 1.0, 2.0, 0.0],
                      [1.0, 1.0, 2.0, 1.0]])[None, None].requires_grad_(True)
    tpool.max_pool_2d(x).sum().backward()
    torch.testing.assert_close(
        x.grad[0, 0], torch.tensor([[0.25, 0.25, 0.5, 0.0],
                                    [0.25, 0.25, 0.5, 0.0]]), rtol=0, atol=0)


# ------------------------------------------------------------ Kernel 5 -----


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 64, 128, 256])
@pytest.mark.parametrize("h", [4, 8, 16, 64])
def test_upsample_backward_plain_vs_jax_vjp(h, c, dtype):
    rng = np.random.default_rng(h * 1000 + c)
    b = 2 if h * h * c <= 16 * 16 * 256 else 1
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    g = rng.standard_normal((b, 2 * h, 2 * h, c)).astype(np.float32)
    got = _nhwc(upsample_2x_backward(_nchw(g, dtype)))
    for fn in (upsample_align_corners_pallas, jax_upsample):
        _, vjp = jax.vjp(fn, jnp.asarray(x, dtype))
        want = np.asarray(vjp(jnp.asarray(g, dtype))[0]).astype(np.float32)
        atol = (2e-6 if dtype == "float32"
                else 2 * 2.0 ** -7 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_upsample_backward_last_row_takes_both_weights():
    """The clamp puts both taps of the last output row on the last input
    row; the transpose adds both weights there, so a gradient of ones sums
    to the column sums of the interpolation matrix (2 per axis, total 4)."""
    g = torch.ones(1, 1, 8, 8)
    gx = upsample_2x_backward(g)
    torch.testing.assert_close(gx.sum(), torch.tensor(64.0), rtol=0,
                               atol=1e-5)
    assert gx[0, 0, -1, -1] > 0


# ------------------------------------------------ attention gradients -----


def test_attention_function_gradients_match_jax_vjp():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 1024, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 128)).astype(np.float32)
    g = rng.standard_normal((2, 1024, 128)).astype(np.float32)
    _, vjp = jax.vjp(jax_attention, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    PooledKVAttentionFunction.apply(tq, tk, tv).backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


# ---------------------------------------------------------------- pools ----


def _grad_pair(jfn, tfn, x: np.ndarray, to_torch, seed=2):
    """Outputs and input gradients of a JAX and a port function for one
    random output gradient."""
    out, vjp = jax.vjp(jfn, jnp.asarray(x))
    g = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    (jgrad,) = vjp(jnp.asarray(g))
    tx = to_torch(x).requires_grad_(True)
    tout = tfn(tx)
    return out, tout, jgrad, tx, g


def test_avg_pool_2d_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 5)).astype(
        np.float32)
    out, tout, jgrad, tx, g = _grad_pair(
        lambda t: jpool.avg_pool_2d(t, 2), tpool.avg_pool_2d, x,
        lambda a: torch.from_numpy(a).permute(0, 3, 1, 2))
    tout.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(tout.detach()), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("length", [8, 9])
def test_max_pool_1d_matches_jax_and_drops_odd_tail(length):
    rng = np.random.default_rng(length)
    x = np.maximum(rng.standard_normal((3, length)), 0).astype(np.float32)
    out, tout, jgrad, tx, g = _grad_pair(
        lambda t: jpool.max_pool_1d(t, 2), tpool.max_pool_1d, x,
        torch.from_numpy)
    assert tout.shape == (3, length // 2)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 4, 4, 6)).astype(
        np.float32)
    out, tout, jgrad, tx, g = _grad_pair(
        jpool.global_avg_pool, tpool.global_avg_pool, x,
        lambda a: torch.from_numpy(a).permute(0, 3, 1, 2))
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------- losses ----


def _pyramid(rng, b=2):
    """A tiny pyramid: two conv levels (NHWC) and two vector levels (one of
    odd length), with 0/1 masks."""
    shapes = [(b, 8, 8, 4), (b, 4, 4, 8), (b, 33), (b, 16)]
    real = [np.maximum(rng.standard_normal(s), 0).astype(np.float32)
            for s in shapes]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    masks = [(rng.random(s[:-1] + (1,) if len(s) == 4 else s) < 0.6)
             .astype(np.float32) for s in shapes]
    return real, fake, masks


def _t(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def test_semantic_reconstruction_loss_and_gradient_match_jax():
    real, fake, masks = _pyramid(np.random.default_rng(5))
    want, jgrads = jax.value_and_grad(
        lambda f: jlosses.semantic_reconstruction_loss(
            [jnp.asarray(r) for r in real], f,
            [jnp.asarray(m) for m in masks]))([jnp.asarray(f) for f in fake])
    tfake = [_t(f).requires_grad_(True) for f in fake]
    got = tlosses.semantic_reconstruction_loss(
        [_t(r) for r in real], tfake, [_t(m) for m in masks])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    for tf, jg in zip(tfake, jgrads):
        grad = tf.grad.permute(0, 2, 3, 1) if tf.dim() == 4 else tf.grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("b", [2, 3, 4])
def test_diversity_loss_matches_jax(b):
    rng = np.random.default_rng(b)
    images = rng.uniform(-1, 1, (b, 8, 8, 3)).astype(np.float32)
    z = rng.standard_normal((b, 16)).astype(np.float32)
    want = jlosses.diversity_loss(jnp.asarray(images), jnp.asarray(z))
    got = tlosses.diversity_loss(_t(images), torch.from_numpy(z))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_diversity_loss_needs_two_samples():
    with pytest.raises(ValueError):
        tlosses.diversity_loss(torch.zeros(1, 3, 4, 4), torch.zeros(1, 8))


@pytest.mark.parametrize("shape", [(3, 1), (3, 3, 8)])
def test_lsgan_losses_match_jax(shape):
    rng = np.random.default_rng(6)
    real = rng.standard_normal(shape).astype(np.float32)
    fake = rng.standard_normal(shape).astype(np.float32)
    jr, jf = jlosses.lsgan_discriminator_loss(jnp.asarray(real),
                                              jnp.asarray(fake))
    tr, tf = tlosses.lsgan_discriminator_loss(torch.from_numpy(real),
                                              torch.from_numpy(fake))
    jg = jlosses.lsgan_generator_loss(jnp.asarray(fake))
    tg = tlosses.lsgan_generator_loss(torch.from_numpy(fake))
    for got, want in ((tr, jr), (tf, jf), (tg, jg)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cpu_backward_wrappers_count_no_launches():
    kernels.reset_launch_counts()
    x = torch.randn(1, 4, 4, 4).contiguous(memory_format=torch.channels_last)
    max_pool_2x2_backward(x, torch.randn(1, 4, 2, 2))
    upsample_2x_backward(x)
    assert sum(kernels.launch_counts().values()) == 0
    with pytest.raises(ValueError):  # g of the wrong shape
        max_pool_2x2_backward(x, torch.randn(1, 4, 4, 4))
    with pytest.raises(ValueError):  # odd output height
        upsample_2x_backward(torch.randn(1, 4, 5, 4))
