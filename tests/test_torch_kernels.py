"""The port's three kernels (ops/cuda/) against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the JAX package's Pallas functions in interpret mode, as
tests/test_pallas_*.py run them, on the same numpy inputs. The CUDA kernels
are held against the plain versions on the card in test_torch_cuda.py.

Tolerances:
  * max pool: bitwise in fp32 and bf16 (a max selects one of its inputs).
  * attention fp32: 1e-5 absolute. Both sides run fp32 logits, softmax and
    p @ v; only the summation order differs (outputs are O(1)).
  * upsample fp32: 2e-6 absolute, as tests/test_pallas_resize.py holds the
    Pallas kernel against the einsum form (FMA contraction, zero terms).
  * bf16: the plain versions round where the JAX kernels do (p before p @ v;
    between the H and W passes), so the band is one bf16 ulp of the largest
    output (2**-7 * max|out|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.ops.pallas.attention import (
    pooled_kv_attention as jax_attention,
)
from semantic_pyramid_for_image_generation_tpu.ops.pallas.pool import (
    max_pool_2x2_pallas,
)
from semantic_pyramid_for_image_generation_tpu.ops.pallas.resize import (
    upsample_align_corners_pallas,
)
from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    pooled_kv_attention,
    pooled_kv_attention_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.pool import (
    max_pool_2x2,
    max_pool_2x2_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    upsample_2x,
    upsample_2x_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    _bilinear_matrix_align_corners,
)

DTYPES = ["float32", "bfloat16"]
POOL_SHAPES = [(2, 256, 256, 4), (1, 128, 128, 8), (2, 128, 128, 1)]
RESIZE_SHAPES = [(2, 8, 8, 16), (1, 16, 8, 128), (2, 4, 4, 64),
                 (1, 32, 32, 256), (1, 64, 64, 128),
                 # the generator's real widths: block 1's C = 512, and the
                 # final block's C = 64 (through _resize_kernel_small_c)
                 (1, 4, 4, 512), (1, 32, 32, 64)]


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _nchw(x: np.ndarray, dtype: str) -> torch.Tensor:
    """NHWC numpy -> the NCHW channels_last view the port's ops take."""
    return _torch(x, dtype).permute(0, 3, 1, 2)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bf16_band(want: np.ndarray, ulps: int = 1) -> float:
    return ulps * 2.0 ** -7 * float(np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_plain_matches_pallas(dtype):
    """Production shape: q (2,1024,32), k (2,256,32), v (2,256,128)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1024, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 128)).astype(np.float32)
    want = np.asarray(jax_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)))
                      ).astype(np.float32)
    got = _np(pooled_kv_attention(_torch(q, dtype), _torch(k, dtype),
                                  _torch(v, dtype)))
    atol = 1e-5 if dtype == "float32" else _bf16_band(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_max_pool_plain_matches_pallas_bitwise(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(max_pool_2x2_pallas(jnp.asarray(x, dtype)))
    got = max_pool_2x2(_nchw(x, dtype)).permute(0, 2, 3, 1)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(
        got.contiguous().view(bits).numpy(),
        want.view(np.int16 if dtype == "bfloat16" else np.int32))


def test_max_pool_plain_propagates_nan():
    x = np.random.default_rng(1).standard_normal((1, 4, 4, 3)).astype(np.float32)
    x[0, 1, 2, 1] = np.nan  # window (0, 1) of channel 1
    got = max_pool_2x2(_nchw(x, "float32")).permute(0, 2, 3, 1).numpy()
    assert np.isnan(got[0, 0, 1, 1])
    assert np.isnan(got).sum() == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RESIZE_SHAPES)
def test_upsample_plain_matches_pallas(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(upsample_align_corners_pallas(jnp.asarray(x, dtype))
                      ).astype(np.float32)
    got = _np(upsample_2x(_nchw(x, dtype)).permute(0, 2, 3, 1))
    atol = 2e-6 if dtype == "float32" else _bf16_band(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_upsample_plain_single_pixel_input():
    """in_size == 1: every output copies the one input (matrix column 0)."""
    x = np.random.default_rng(2).standard_normal((2, 1, 1, 5)).astype(np.float32)
    got = upsample_2x(_nchw(x, "float32")).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(x, (2, 2, 2, 5)))


def test_bilinear_matrix_matches_jax_package():
    from semantic_pyramid_for_image_generation_tpu.ops.resize import (
        _bilinear_matrix_align_corners as jax_matrix,
    )

    for n in (1, 2, 4, 7, 128):
        np.testing.assert_array_equal(_bilinear_matrix_align_corners(n, 2 * n),
                                      jax_matrix(n, 2 * n))


def test_cpu_tensors_take_plain_versions_without_counting():
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(max_pool_2x2(x), max_pool_2x2_plain(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(upsample_2x(x), upsample_2x_plain(x),
                               rtol=0, atol=0)
    q, k, v = torch.randn(1, 16, 4), torch.randn(1, 4, 4), torch.randn(1, 4, 8)
    torch.testing.assert_close(pooled_kv_attention(q, k, v),
                               pooled_kv_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == {
        "pooled_kv_attention": 0, "max_pool_2x2": 0, "upsample_2x": 0,
        "max_pool_2x2_backward": 0, "upsample_2x_backward": 0,
        "batch_norm_stats": 0, "batch_norm_apply": 0,
        "batch_norm_backward_sums": 0, "batch_norm_backward_dx": 0}


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        max_pool_2x2(torch.randn(1, 2, 5, 4))          # odd H
    with pytest.raises(ValueError):
        upsample_2x(torch.randn(2, 4, 4))              # not 4-d
    with pytest.raises(ValueError):                    # k / q channels differ
        pooled_kv_attention(torch.randn(1, 8, 4), torch.randn(1, 2, 3),
                            torch.randn(1, 2, 8))
    with pytest.raises(ValueError):                    # no kernel for meta
        max_pool_2x2(torch.empty(1, 2, 4, 4, device="meta"))
