"""Kernel 1: pooled-KV attention forward (csrc/attention.cu), its plain
version, its launch count, and the autograd Function around it.

Replaces the JAX package's Pallas `pooled_kv_attention` forward
(ops/pallas/attention.py). bf16 runs on the tensor cores and rounds p to bf16
before p @ v, as the Pallas kernel does. fp32 runs the kernel too, on full
fp32 FMAs, so the TPU's reason to route fp32 elsewhere does not arise. The
backward is the plain form of the JAX package's `_bwd`, which JAX computes
with XLA einsums, not in a Pallas kernel. The kernel is the torch custom op
`spig::pooled_kv_attention`, built as the pool's are (ops/cuda/pool.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda import _launch
from semantic_pyramid_for_image_generation_torch.ops.cuda._launch import (
    NAMESPACE,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.build import (
    check,
    library,
)

MAX_CHANNELS = 256  # c8 and c2 limit of csrc/attention.cu

launches = 0  # kernel launches since the last reset (ops/cuda/__init__.py)


def pooled_kv_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v with fp32 logits and softmax (float64 stays
    float64), p cast to v's dtype before p @ v, as the JAX kernel does."""
    wide = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bqc,bkc->bqk", q.to(wide), k.to(wide))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkc->bqc", p.to(v.dtype), v)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> int:
    """Raise ValueError unless the kernel takes q, k and v (C8, C2 <= 256,
    B <= 65535, contiguous, one dtype of float32 or bfloat16); returns the
    dtype code. Checks what the kernel needs, not where the tensors lie."""
    code = _launch.dtype_code("pooled_kv_attention", q, k, v)
    b, c8, c2 = q.shape[0], q.shape[2], v.shape[2]
    if c8 > MAX_CHANNELS or c2 > MAX_CHANNELS or b > 65535:
        raise ValueError(f"pooled_kv_attention: the kernel takes C8, C2 <= "
                         f"{MAX_CHANNELS} and B <= 65535, got B={b} C8={c8} "
                         f"C2={c2}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("pooled_kv_attention: q, k and v must be contiguous")
    return code


@torch.library.custom_op(f"{NAMESPACE}::pooled_kv_attention",
                         mutates_args=(), device_types="cuda")
def _pooled_kv_attention_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Kernel 1 on CUDA tensors."""
    global launches
    code = check_kernel_inputs(q, k, v)
    b, nq, c8 = q.shape
    nk, c2 = v.shape[1], v.shape[2]
    out = torch.empty((b, nq, c2), dtype=v.dtype, device=v.device)
    check(library().spig_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, nq, nk, c8, c2, code, _launch.stream(q.device)),
        "pooled_kv_attention")
    launches += 1
    return out


_pooled_kv_attention_op.register_kernel("cpu")(pooled_kv_attention_plain)


@_pooled_kv_attention_op.register_fake
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def pooled_kv_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, C8), k (B, Nk, C8), v (B, Nk, C2) -> (B, Nq, C2): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]):
        raise ValueError(
            f"pooled_kv_attention: need q (B, Nq, C8), k (B, Nk, C8), "
            f"v (B, Nk, C2), got {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)}")
    _launch.check_devices("pooled_kv_attention", q, k, v)
    return _pooled_kv_attention_op(q, k, v)


def pooled_kv_attention_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T) v for the output gradient g, as the JAX
    package's `_bwd`: recompute p in fp32 (float64 stays float64), then dv,
    dp, dlogits, dq, dk in that precision, each cast to its input's dtype."""
    wide = torch.promote_types(q.dtype, torch.float32)
    qw, kw, vw, gw = (t.to(wide) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqc,bkc->bqk", qw, kw), dim=-1)
    dv = torch.einsum("bqk,bqc->bkc", p, gw)
    dp = torch.einsum("bqc,bkc->bqk", gw, vw)
    dlogits = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkc->bqc", dlogits, kw)
    dk = torch.einsum("bqk,bqc->bkc", dlogits, qw)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class PooledKVAttentionFunction(torch.autograd.Function):
    """Kernel 1 forward (the plain version on the CPU); the plain backward
    recomputes the attention map instead of saving it, as the JAX custom VJP
    does."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return pooled_kv_attention(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        return pooled_kv_attention_backward_plain(*ctx.saved_tensors, g)
