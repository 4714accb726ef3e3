"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the autograd Functions around them checked numerically on the CPU.

The kernel tests are marked `cuda` and skip on a host without an NVIDIA
GPU. The gradchecks run the Functions' plain versions in float64 on the
CPU, so they run everywhere. This file imports torch and the port only (no
JAX), so it also runs on the machine with the card, where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances:
  * max pool forward and backward: bitwise in fp32 and bf16, NaN included
    (the backward's g/2 and g/4 are exact, and its 2x2 windows disjoint).
  * upsample backward fp32: 1e-5 of max(1, max |gx|) (summation order; each
    input gathers up to 16 weighted outputs). Repeated launches are bitwise
    equal (no atomics).
  * attention fp32: 1e-4 absolute. Same fp32 math, another summation order
    (online softmax over key tiles); logits up to ~25 carry their rounding
    into exp. Repeated launches are bitwise equal (no atomics).
  * upsample fp32: 1e-5 absolute (a few ulps: FMA contraction and the zero
    terms of the plain version's matrix form). Repeated launches are bitwise
    equal.
  * bf16: two bf16 ulps of the largest output (2 * 2**-7 * max|out|). The
    attention kernel rounds p to bf16 before p @ v where the plain version
    does (its exp is ex2.approx and its row sums run in another order, so a
    p may round the other way); the upsample kernels round once, the plain
    versions between their two passes.
"""

import pytest
import torch

from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    PooledKVAttentionFunction,
    pooled_kv_attention,
    pooled_kv_attention_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.pool import (
    MaxPool2x2Function,
    max_pool_2x2,
    max_pool_2x2_backward,
    max_pool_2x2_backward_plain,
    max_pool_2x2_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    Upsample2xFunction,
    upsample_2x,
    upsample_2x_backward,
    upsample_2x_backward_plain,
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
@pytest.mark.parametrize("b,c8,c2,nq,nk", [
    (16, 32, 128, 1024, 256),  # the generator's site
    (3, 4, 16, 1024, 256),     # the tiny widths
    (3, 128, 256, 100, 70),    # two output chunks; ragged query and key tiles
    (3, 8, 40, 33, 1),         # one key
    (2, 256, 128, 70, 300),    # the widest q k^T
    (2, 12, 17, 65, 129),      # element-wise staging, odd C2
    (2, 32, 256, 64, 4096),    # K and V larger than shared memory
])
def test_attention_kernel_matches_plain(cuda, dtype, b, c8, c2, nq, nk):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k = (torch.randn(b, n, c8, device=cuda, generator=g).to(dt)
            for n in (nq, nk))
    v = torch.randn(b, nk, c2, device=cuda, generator=g).to(dt)
    want = pooled_kv_attention_plain(q, k, v).float()
    got = pooled_kv_attention(q, k, v)
    again = pooled_kv_attention(q, k, v)
    torch.cuda.synchronize()
    atol = 1e-4 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol)
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


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
@pytest.mark.parametrize("shape", [
    # the serving and train-step sites (bf16 and fp32 lists together)
    (16, 512, 4, 4), (16, 512, 8, 8), (16, 512, 16, 16), (16, 256, 16, 16),
    (16, 256, 32, 32), (16, 128, 32, 32), (16, 128, 64, 64), (16, 64, 64, 64),
    (16, 64, 128, 128),
    # edges: H = W = 1, C not a multiple of 4 or 8, column tiles and row
    # strips that do not divide W or H, H = 1 beside a wide W
    (2, 512, 4, 4), (2, 64, 128, 128), (1, 3, 5, 7), (2, 8, 1, 1),
    (1, 3, 1, 1), (2, 5, 6, 10), (1, 16, 10, 14), (2, 8, 18, 30),
    (1, 16, 1, 34), (1, 512, 2, 3), (3, 64, 33, 1)])
def test_upsample_kernel_matches_plain(cuda, dtype, shape):
    x = _cl(torch.randn(shape, device=cuda).to(getattr(torch, dtype)))
    want = upsample_2x_plain(x).float()
    got = upsample_2x(x)
    atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol)
    assert torch.equal(got, upsample_2x(x))  # bitwise repeatable


def _generate_sites(b, dtype):
    """One generate's max-pool inputs (the 5 VGG pools, the attention KV pool)
    and upsample inputs (main and residual of the 5 blocks, the final block;
    in bf16 the residual upsamples the block's output channels)."""
    pools = [(b, 64, 256, 256), (b, 128, 128, 128), (b, 256, 64, 64),
             (b, 512, 32, 32), (b, 512, 16, 16), (b, 256, 32, 32)]
    ups = []
    for cin, cout, hw in ((512, 512, 4), (512, 512, 8), (512, 256, 16),
                          (256, 128, 32), (128, 64, 64)):
        ups += [(b, cin, hw, hw), (b, cin if dtype == "float32" else cout,
                                   hw, hw)]
    return pools, ups + [(b, 64, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [49, 32])
def test_forward_kernels_at_the_validation_and_grid_batches(cuda, dtype, b):
    """Validation generates at twice the train batch (32 at batch 16), the
    sweep grid at 49 rows (7 images x 7 levels): Kernels 1-3 at every site of
    one generate at those batches, under the tolerances above (bitwise for
    the max pool). 49 is odd and no multiple of 16."""
    g = torch.Generator(cuda).manual_seed(b)
    dt = getattr(torch, dtype)
    q = torch.randn(b, 1024, 32, device=cuda, generator=g).to(dt)
    k = torch.randn(b, 256, 32, device=cuda, generator=g).to(dt)
    v = torch.randn(b, 256, 128, device=cuda, generator=g).to(dt)
    want = pooled_kv_attention_plain(q, k, v).float()
    atol = 1e-4 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(pooled_kv_attention(q, k, v).float(), want,
                               rtol=0, atol=atol)
    pools, ups = _generate_sites(b, dtype)
    for shape in pools:
        x = _cl(torch.randn(shape, device=cuda, generator=g).to(dt))
        torch.testing.assert_close(max_pool_2x2(x), max_pool_2x2_plain(x),
                                   rtol=0, atol=0, msg=str(shape))
    for shape in ups:
        x = _cl(torch.randn(shape, device=cuda, generator=g).to(dt))
        want = upsample_2x_plain(x).float()
        atol = (1e-5 if dtype == "float32"
                else 2 * 2.0 ** -7 * want.abs().max().item())
        torch.testing.assert_close(upsample_2x(x).float(), want, rtol=0,
                                   atol=atol, msg=str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample_kernel_unaligned_input(cuda, dtype):
    """A view one element into its storage: not 16-byte aligned, so the
    kernel takes its element-wise (VEC = 1) form."""
    b, c, h, w = 2, 64, 6, 10
    flat = torch.randn(b * h * w * c + 1, device=cuda).to(getattr(torch, dtype))
    x = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16
    want = upsample_2x_plain(x).float()
    atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(upsample_2x(x).float(), want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_kernels_count_launches(cuda):
    kernels.reset_launch_counts()
    x = _cl(torch.randn(1, 8, 4, 4, device=cuda))
    max_pool_2x2(x)
    upsample_2x(x)
    upsample_2x(x)
    q = torch.randn(1, 16, 4, device=cuda)
    pooled_kv_attention(q, q[:, :4], torch.randn(1, 4, 8, device=cuda))
    max_pool_2x2_backward(x, _cl(torch.randn(1, 8, 2, 2, device=cuda)))
    upsample_2x_backward(x)
    assert kernels.launch_counts() == {
        "pooled_kv_attention": 1, "max_pool_2x2": 1, "upsample_2x": 2,
        "max_pool_2x2_backward": 1, "upsample_2x_backward": 1}
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


def _tie_heavy(shape, dtype, device, seed=0):
    """Post-ReLU values quantized to quarters: most 2x2 windows tie."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).relu()
    return _cl(torch.clamp(torch.round(x * 4) / 4, max=1.5).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 256, 256), (3, 5, 6, 10),
                                   (2, 512, 16, 16), (4, 1, 128, 128),
                                   (1, 1, 2, 2)])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "permuted"])
def test_max_pool_backward_kernel_bitwise(cuda, dtype, shape, layout):
    """Tie-heavy x; the incoming gradient in the layouts autograd hands over
    (channels_last from cuDNN, NCHW-contiguous, a permuted view)."""
    dt = getattr(torch, dtype)
    x = _tie_heavy(shape, dt, cuda)
    b, c, h, w = shape
    g = torch.randn(b, c, h // 2, w // 2, device=cuda).to(dt)
    if layout == "channels_last":
        g = _cl(g)
    elif layout == "permuted":
        g = g.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    got = max_pool_2x2_backward(x, g)
    torch.testing.assert_close(got, max_pool_2x2_backward_plain(x, g),
                               rtol=0, atol=0)
    if shape[1] == 1:  # a 0/1 mask: ties in nearly every window
        m = _cl((torch.rand(shape, device=cuda) < 0.5).to(dt))
        torch.testing.assert_close(max_pool_2x2_backward(m, g),
                                   max_pool_2x2_backward_plain(m, g),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_max_pool_backward_kernel_nan_inputs(cuda, dtype):
    dt = getattr(torch, dtype)
    x = torch.randn(2, 16, 8, 8, device=cuda).to(dt)
    x[0, 3, 2, 5] = float("nan")
    x[1, 15, 7, 0] = float("nan")
    x = _cl(x)
    g = _cl(torch.randn(2, 16, 4, 4, device=cuda).to(dt))
    got = max_pool_2x2_backward(x, g)
    torch.testing.assert_close(got, max_pool_2x2_backward_plain(x, g),
                               rtol=0, atol=0, equal_nan=True)
    assert float(got[0, 3, 2:4, 4:6].abs().sum()) == 0.0  # NaN's window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # the train step's sites (the gradients of G's upsample outputs)
    (16, 512, 8, 8), (16, 512, 16, 16), (16, 512, 32, 32), (16, 256, 32, 32),
    (16, 256, 64, 64), (16, 128, 64, 64), (16, 128, 128, 128),
    (16, 64, 128, 128), (16, 64, 256, 256),
    # edges: H = W = 1, C not a multiple of 4 or 8, tiles that do not divide
    # H or W, H = 1 beside a wide W
    (2, 512, 8, 8), (2, 64, 256, 256), (1, 3, 10, 14), (2, 8, 2, 2),
    (2, 5, 4, 6), (2, 8, 18, 30), (1, 16, 2, 34)])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_upsample_backward_kernel_matches_plain(cuda, dtype, shape, layout):
    """g has the forward's output shape (B, C, 2H, 2W)."""
    g = torch.randn(shape, device=cuda).to(getattr(torch, dtype))
    if layout == "channels_last":
        g = _cl(g)
    want = upsample_2x_backward_plain(g).float()
    got = upsample_2x_backward(g)
    scale = max(1.0, want.abs().max().item())
    atol = 1e-5 * scale if dtype == "float32" else 2 * 2.0 ** -7 * scale
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol)
    assert torch.equal(got, upsample_2x_backward(g))  # bitwise repeatable


@pytest.mark.cuda
def test_functions_take_the_kernels_forward_and_backward(cuda):
    kernels.reset_launch_counts()
    x = _cl(torch.randn(2, 16, 8, 8, device=cuda)).requires_grad_(True)
    y = Upsample2xFunction.apply(MaxPool2x2Function.apply(x))
    y.square().sum().backward()
    assert kernels.launch_counts() == {
        "pooled_kv_attention": 0, "max_pool_2x2": 1, "upsample_2x": 1,
        "max_pool_2x2_backward": 1, "upsample_2x_backward": 1}
    xc = x.detach().cpu().requires_grad_(True)
    Upsample2xFunction.apply(MaxPool2x2Function.apply(xc)).square().sum(
        ).backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=0, atol=1e-5)


# ------------------------------------------- gradchecks, CPU, float64 -----


def test_max_pool_function_gradcheck():
    """Distinct values (no ties), where the gradient is the derivative."""
    x = torch.randn(2, 3, 6, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(MaxPool2x2Function.apply, (x,))


def test_upsample_function_gradcheck():
    for shape in ((2, 3, 4, 5), (1, 2, 1, 3)):
        x = torch.randn(shape, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(Upsample2xFunction.apply, (x,))


def test_attention_function_gradcheck():
    q, k, v = (torch.randn(2, n, c, dtype=torch.float64, requires_grad=True)
               for n, c in ((6, 4), (3, 4), (3, 5)))
    assert torch.autograd.gradcheck(PooledKVAttentionFunction.apply, (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_device_fid_reduction_on_the_card(cuda, scale):
    """The FID's float32 device reduction (two cuSOLVER eigh calls) against
    the host float64 one (scipy sqrtm), on non-negative inception-like
    activations: well-conditioned (256 dims, 400 samples) within rtol 1e-3
    at both scales; at 1e-4, a random-init Inception's activation scale, the
    covariance entries are ~1e-10 and need the reduction's rescaling. Rank
    63 of 2048 (64 samples, as the smoke's validation): finite."""
    import numpy as np

    from semantic_pyramid_for_image_generation_torch.eval import fid

    rng = np.random.default_rng(0)
    for dim, n in ((256, 400), (2048, 64)):
        real = np.abs(rng.standard_normal((n, dim))) * 0.4 * scale
        fake = (np.abs(0.8 * rng.standard_normal((n, dim))) * 0.4
                + 0.1) * scale
        moments = [real.sum(0), real.T @ real, fake.sum(0), fake.T @ fake]
        got = float(fid.fid_from_moments_device(n, *(
            torch.from_numpy(m).float().to(cuda) for m in moments)))
        assert np.isfinite(got), (dim, n)
        if dim == 256:
            want = fid.fid_from_statistics(
                *fid.statistics_from_moments(n, *moments[:2]),
                *fid.statistics_from_moments(n, *moments[2:]))
            np.testing.assert_allclose(got, want, rtol=1e-3)


# --------------------------------------------- the VGG-16 fine-tune -----

# the five max-pool inputs of a fine-tune step at batch 256, 256x256
FINETUNE_POOLS = [(256, 64, 256, 256), (256, 128, 128, 128),
                  (256, 256, 64, 64), (256, 512, 32, 32), (256, 512, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FINETUNE_POOLS)
def test_max_pool_kernels_at_the_finetune_sites(cuda, dtype, shape):
    """Kernels 2 and 4 over a whole batch-256 site (pool 1 holds 1.07e9
    elements), bitwise against their plain versions run on chunks of 32
    images (the plain backward upcasts to fp32, ~15 GB at once), on
    tie-heavy inputs."""
    dt = getattr(torch, dtype)
    x = _tie_heavy(shape, dt, cuda, seed=shape[1])
    b, c, h, w = shape
    gen = torch.Generator(cuda).manual_seed(1)
    g = _cl(torch.randn((b, c, h // 2, w // 2), generator=gen,
                        device=cuda).to(dt))
    out = max_pool_2x2(x)
    gx = max_pool_2x2_backward(x, g)
    for i in range(0, b, 32):
        chunk = slice(i, i + 32)
        assert torch.equal(out[chunk], max_pool_2x2_plain(x[chunk])), i
        assert torch.equal(gx[chunk],
                           max_pool_2x2_backward_plain(x[chunk], g[chunk])), i


FT_LR = 1e-4
# the share of parameter elements that may lie further than 1e-2 lr plus
# one fp32 ulp from the CPU's: the sound runs read 0.55-0.70%, a gradient
# rounded through bf16 in the pool backward 1.87% (see the two tests below)
FT_OFF_LIMIT = 1.2e-2


def _tiny_finetune(device, seed: int):
    """Two fp32 fine-tune steps of a tiny VGG16 (widths / 16, 64x64, 5
    classes, batch 4) on `device` from the seed's init, batches and pinned
    dropout masks: ([(loss, top1)] per step, the state dict on the CPU)."""
    import numpy as np

    from semantic_pyramid_for_image_generation_torch.cli import (
        vgg16_finetune as ft,
    )
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
        VGG16,
        dropout_keep_mask,
    )

    cfg = PyramidGANConfig(vgg_width_factor=16, image_size=64, num_classes=5)
    init = VGG16(cfg, return_output=True)
    init.initialize(torch.Generator().manual_seed(seed))
    with torch.device(device):
        model = VGG16(cfg, return_output=True)
    model.load_state_dict(init.state_dict())
    step = ft.make_finetune_step(model, ft.make_optimizer(model, FT_LR))
    rng = np.random.default_rng(seed)
    metrics = []
    for i in range(2):
        images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
        labels = rng.integers(0, 5, 4)
        masks = [dropout_keep_mask((4, cfg.vgg_fc7_dim), torch.device("cpu"),
                                   torch.Generator().manual_seed(
                                       100 * seed + 10 * i + j))
                 for j in range(2)]
        x, y = ft.batch_to_device(images, labels, device)
        loss, top1 = step(x, y, dropout_masks=[m.to(device) for m in masks])
        metrics.append((float(loss), float(top1)))
    return metrics, {k: v.cpu() for k, v in model.state_dict().items()}


def _off_elements(got: dict, want: dict) -> tuple:
    """(the largest |got - want| of any element, and per tensor the
    elements further than 1e-2 lr plus one fp32 ulp from `want`)."""
    worst, off = 0.0, {}
    for key, value in got.items():
        err = (value - want[key]).abs()
        worst = max(worst, float(err.max()))
        off[key] = err > 1e-2 * FT_LR + 2.0 ** -23 * want[key].abs()
    return worst, off


def _count(off: dict) -> int:
    return sum(int(m.sum()) for m in off.values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiny_finetune_step_on_card_matches_cpu(cuda, monkeypatch, seed):
    """Two fp32 fine-tune steps of a tiny VGG16 (widths / 16, 64x64, 5
    classes) on the card against the CPU from the same weights with the
    same pinned dropout masks: loss within 1e-4 relative, top-1 equal;
    parameters within 4 * lr everywhere (two Adam steps), and within 1e-2 *
    lr plus one fp32 ulp on all but FT_OFF_LIMIT of the elements. At these
    widths the last pool's maps are 2x2 and most gradients are exactly zero
    (dead ReLUs, dropped units); a sum that lands near zero in another
    order flips a gradient's sign, and Adam turns a gradient near its eps
    (1e-8) into a step that follows its size.

    The witness that the kernels are not the cause: the same steps on the
    card with Kernels 2 and 4 swapped for their plain versions are off on
    much the same elements (the overlap is printed and must be at least
    half of either set), and the kernels launch 10 times each in the first
    run, none in the second."""
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.ops.cuda import pool

    cpu_metrics, want = _tiny_finetune(torch.device("cpu"), seed)
    kernels.reset_launch_counts()
    runs = {"kernels": _tiny_finetune(cuda, seed)}
    counts = kernels.launch_counts()
    assert counts["max_pool_2x2"] == 10 and counts["max_pool_2x2_backward"] == 10
    monkeypatch.setattr(pool, "max_pool_2x2", max_pool_2x2_plain)
    monkeypatch.setattr(pool, "max_pool_2x2_backward",
                        max_pool_2x2_backward_plain)
    runs["plain"] = _tiny_finetune(cuda, seed)
    assert kernels.launch_counts() == counts
    off = {}
    for route, (metrics, got) in runs.items():
        for (loss, top1), (cpu_loss, cpu_top1) in zip(metrics, cpu_metrics):
            assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss), route
            assert top1 == cpu_top1, route
        worst, off[route] = _off_elements(got, want)
        assert worst <= 4 * FT_LR, (route, worst)
    n = {route: _count(o) for route, o in off.items()}
    both = sum(int((off["kernels"][k] & off["plain"][k]).sum()) for k in want)
    total = sum(m.numel() for m in want.values())
    route_diff = max(float((runs["kernels"][1][k] - runs["plain"][1][k])
                           .abs().max()) for k in want)
    print(f"seed {seed}: off with the kernels {n['kernels']}, with the plain "
          f"pools {n['plain']}, on both {both}, of {total} elements; "
          f"kernels vs plain on the card max |difference| {route_diff:.3g}")
    for route in off:
        assert n[route] <= FT_OFF_LIMIT * total, (route, n[route], total)
    assert 2 * both >= max(n.values()), (n, both)


def _dropped_last_window_row(x, g):
    gx = max_pool_2x2_backward_plain(x, g)
    gx[:, :, -2:] = 0
    return gx


def _dropped_last_image_at_pool1(x, g):
    gx = max_pool_2x2_backward_plain(x, g)
    if x.shape[-1] == 64:
        gx[-1] = 0
    return gx


def _gradient_through_bf16(x, g):
    return max_pool_2x2_backward_plain(x, g.bfloat16().float())


def _first_max_takes_ties(x, g):
    _, index = torch.nn.functional.max_pool2d(x, 2, return_indices=True)
    return torch.ops.aten.max_pool2d_with_indices_backward(
        g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, index)


@pytest.mark.cuda
@pytest.mark.parametrize("fault, caught", [
    (_dropped_last_window_row, True), (_dropped_last_image_at_pool1, True),
    (_gradient_through_bf16, True), (_first_max_takes_ties, False)])
def test_tiny_finetune_card_check_against_planted_faults(cuda, monkeypatch,
                                                         fault, caught):
    """The card-vs-CPU check above (seed 0) with a fault planted in the
    card's max-pool backward: prints the share of elements off, which
    FT_OFF_LIMIT must catch. A wrong tie rule is the one fault it cannot
    see: with random inputs every tied window holds dead ReLUs, whose
    gradient the ReLU backward drops whatever the pool routed there. The
    tie rule is held bitwise on tie-heavy inputs instead
    (test_max_pool_kernels_at_the_finetune_sites)."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda import pool

    _, want = _tiny_finetune(torch.device("cpu"), 0)
    monkeypatch.setattr(pool, "max_pool_2x2_backward", fault)
    _, got = _tiny_finetune(cuda, 0)
    worst, off = _off_elements(got, want)
    share = _count(off) / sum(m.numel() for m in off.values())
    print(f"{fault.__name__}: {100 * share:.3f}% of elements off (limit "
          f"{100 * FT_OFF_LIMIT:g}%), max |difference| {worst / FT_LR:.3f} lr")
    assert (share > FT_OFF_LIMIT) == caught, fault.__name__


@pytest.mark.cuda
def test_dropout_masks_from_a_seeded_generator_repeat(cuda):
    from semantic_pyramid_for_image_generation_torch.cli.vgg16_finetune import (
        dropout_generator,
    )
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
        dropout_keep_mask,
    )

    shape = (256, 4096)
    a = dropout_keep_mask(shape, cuda, dropout_generator(3, 7, cuda))
    b = dropout_keep_mask(shape, cuda, dropout_generator(3, 7, cuda))
    c = dropout_keep_mask(shape, cuda, dropout_generator(3, 8, cuda))
    assert a.device.type == "cuda" and a.dtype == torch.bool
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.49 < float(a.float().mean()) < 0.51
