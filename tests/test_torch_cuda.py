"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips on a host without an NVIDIA GPU. This file
imports torch and the port only (no JAX), so it also runs on the machine
with the card, where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances:
  * max pool: bitwise in fp32 and bf16, NaN included.
  * attention fp32: 1e-4 absolute. Same fp32 math, another summation order
    (online softmax over key tiles); logits up to ~25 carry their rounding
    into exp.
  * upsample fp32: 1e-5 absolute (a few ulps: FMA contraction and the zero
    terms of the plain version's matrix form).
  * bf16: two bf16 ulps of the largest output (2 * 2**-7 * max|out|). The
    kernels keep attention probabilities in fp32 and round the upsample once;
    the plain versions round p before p @ v and between the two passes.
"""

import pytest
import torch

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

DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c8,c2,nq,nk", [(32, 128, 1024, 256), (4, 16, 1024, 256),
                                         (128, 256, 100, 70), (8, 40, 33, 1)])
def test_attention_kernel_matches_plain(cuda, dtype, c8, c2, nq, nk):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k = (torch.randn(3, n, c8, device=cuda, generator=g).to(dt)
            for n in (nq, nk))
    v = torch.randn(3, nk, c2, device=cuda, generator=g).to(dt)
    want = pooled_kv_attention_plain(q, k, v).float()
    got = pooled_kv_attention(q, k, v).float()
    torch.cuda.synchronize()
    atol = 1e-4 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 256, 256), (3, 5, 6, 10),
                                   (2, 512, 16, 16), (1, 1, 2, 2)])
def test_max_pool_kernel_bitwise(cuda, dtype, shape):
    x = _cl(torch.randn(shape, device=cuda).to(getattr(torch, dtype)))
    torch.testing.assert_close(max_pool_2x2(x), max_pool_2x2_plain(x),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 512, 4, 4), (2, 64, 128, 128),
                                   (1, 3, 5, 7), (2, 8, 1, 1)])
def test_upsample_kernel_matches_plain(cuda, dtype, shape):
    x = _cl(torch.randn(shape, device=cuda).to(getattr(torch, dtype)))
    want = upsample_2x_plain(x).float()
    got = upsample_2x(x).float()
    atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_kernels_count_launches(cuda):
    kernels.reset_launch_counts()
    x = _cl(torch.randn(1, 8, 4, 4, device=cuda))
    max_pool_2x2(x)
    upsample_2x(x)
    upsample_2x(x)
    q = torch.randn(1, 16, 4, device=cuda)
    pooled_kv_attention(q, q[:, :4], torch.randn(1, 4, 8, device=cuda))
    assert kernels.launch_counts() == {
        "pooled_kv_attention": 1, "max_pool_2x2": 1, "upsample_2x": 2}
    with pytest.raises(ValueError):  # NCHW-contiguous memory is refused
        max_pool_2x2(torch.randn(1, 8, 4, 4, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_max_pool_kernel_propagates_nan(cuda, dtype):
    x = torch.randn(2, 16, 8, 8, device=cuda).to(getattr(torch, dtype))
    x[0, 3, 2, 5] = float("nan")
    x[1, 15, 7, 0] = float("nan")
    got = max_pool_2x2(_cl(x))
    assert torch.isnan(got[0, 3, 1, 2]) and torch.isnan(got[1, 15, 3, 0])
    assert int(torch.isnan(got).sum()) == 2
    torch.testing.assert_close(got, max_pool_2x2_plain(x), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_tiny_generate_on_card_matches_cpu(cuda, dtype, atol):
    """The whole generate path through the kernels against the same weights
    on the CPU (plain versions). fp32: cuDNN (TF32 off) and the CPU differ
    in summation order only; bf16 rounds in other places on the two sides."""
    import dataclasses

    import numpy as np

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.masks import (
        MaskSchedule,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_generate_fn,
    )

    cfg = dataclasses.replace(PyramidGANConfig().tiny(), compute_dtype=dtype)
    cpu = torch.device("cpu")
    g_cpu, v_cpu = make_models(cfg, cpu, torch.Generator().manual_seed(1))
    advance_spectral_norm_(g_cpu, 10)
    g_gpu, v_gpu = make_models(cfg, cuda)
    g_gpu.load_state_dict(g_cpu.state_dict())
    v_gpu.load_state_dict(v_cpu.state_dict())
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    labels = np.eye(cfg.num_classes, dtype=np.float32)[[4, 11]]
    noise = rng.standard_normal((2, cfg.latent_dim)).astype(np.float32)
    schedule = MaskSchedule(cfg)
    masks = schedule.batch([schedule.inference_masks(5)] * 2)
    outs = []
    for device, fn in ((cpu, make_generate_fn(g_cpu, v_cpu)),
                       (cuda, make_generate_fn(g_gpu, v_gpu))):
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        outs.append(fn(t(images), [t(m) for m in masks], t(labels),
                       t(noise)).float().cpu())
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=atol)
