"""What the kernel wrappers refuse, held on CPU tensors.

The CUDA kernels take a narrower set of inputs than their plain versions:
Kernel 1 (pooled-KV attention) C8, C2 <= 256, B <= 65535, contiguous q, k
and v of one dtype, float32 or bfloat16; Kernel 5 (upsample backward) an
even-sized (B, C, 2H, 2W) gradient. `check_kernel_inputs` is what the
attention wrapper runs before a launch; it checks the tensors, not their
device, so it is held here on the CPU. On the CPU the wrappers run the
plain versions, which take any such input.
"""

import pytest
import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda import _launch
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    check_kernel_inputs,
    pooled_kv_attention,
    pooled_kv_attention_plain,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.resize import (
    upsample_2x_backward,
    upsample_2x_backward_plain,
)


def _qkv(b=2, nq=8, nk=4, c8=4, c2=6, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(b, n, c, generator=g).to(dtype)
                 for n, c in ((nq, c8), (nk, c8), (nk, c2)))


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("c8,c2", [(256, 256), (1, 1), (32, 128)])
def test_attention_kernel_takes(dtype, code, c8, c2):
    assert check_kernel_inputs(*_qkv(c8=c8, c2=c2, dtype=dtype)) == code


@pytest.mark.parametrize("case", [
    "c8_over_256", "c2_over_256", "batch_over_65535", "q_transposed",
    "k_strided", "v_transposed", "mixed_dtypes", "float16", "float64"])
def test_attention_kernel_refuses(case):
    q, k, v = _qkv()
    if case == "c8_over_256":
        q, k, v = _qkv(c8=257)
    elif case == "c2_over_256":
        q, k, v = _qkv(c2=257)
    elif case == "batch_over_65535":
        q, k, v = _qkv(b=65536, nq=1, nk=1, c8=1, c2=1)
    elif case == "q_transposed":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "k_strided":
        k = torch.randn(2, 8, 4)[:, ::2]
    elif case == "v_transposed":
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "mixed_dtypes":
        v = v.to(torch.bfloat16)
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "float64":
        q, k, v = (t.double() for t in (q, k, v))
    with pytest.raises(ValueError):
        check_kernel_inputs(q, k, v)


def test_attention_plain_takes_what_the_kernel_refuses():
    """On the CPU the wrapper runs the plain version for any layout and
    width: the kernel's limits are not applied to CPU tensors."""
    q, k, v = _qkv(c2=300)
    q = q.transpose(0, 1).contiguous().transpose(0, 1)
    torch.testing.assert_close(pooled_kv_attention(q, k, v),
                               pooled_kv_attention_plain(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 4, 7), (3, 4, 4),
                                   (1, 2, 3, 4, 4)])
def test_upsample_backward_refuses_shapes(shape):
    """The gradient of a 2x upsample: 4-d with even H and W."""
    with pytest.raises(ValueError):
        upsample_2x_backward(torch.randn(shape))


@pytest.mark.parametrize("layout", ["contiguous", "channels_last",
                                    "transposed"])
def test_upsample_backward_plain_takes_any_layout(layout):
    g = torch.randn(2, 3, 6, 8)
    if layout == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last)
    elif layout == "transposed":
        g = g.transpose(2, 3).contiguous().transpose(2, 3)
    torch.testing.assert_close(upsample_2x_backward(g),
                               upsample_2x_backward_plain(g.contiguous()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtypes", [(torch.float16,), (torch.float64,),
                                    (torch.float32, torch.bfloat16)])
def test_kernels_take_float32_or_bfloat16_of_one_dtype(dtypes):
    with pytest.raises(ValueError):
        _launch.dtype_code("kernel", *(torch.zeros(1, dtype=d) for d in dtypes))


def test_wrappers_refuse_devices_without_a_kernel():
    with pytest.raises(ValueError):
        upsample_2x_backward(torch.empty(1, 2, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        pooled_kv_attention(*(t.to("meta") for t in _qkv()))
