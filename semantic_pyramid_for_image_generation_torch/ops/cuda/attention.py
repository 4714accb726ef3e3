"""Kernel 1: pooled-KV attention forward (csrc/attention.cu), its plain
version and its launch count.

Replaces the JAX package's Pallas `pooled_kv_attention` forward
(ops/pallas/attention.py). fp32 runs the kernel too: its dots are full fp32
FMAs, so the TPU's reason to route fp32 elsewhere does not arise.
"""

from __future__ import annotations

import torch

from semantic_pyramid_for_image_generation_torch.ops.cuda import _launch
from semantic_pyramid_for_image_generation_torch.ops.cuda.build import (
    check,
    library,
)

MAX_CHANNELS = 256  # c8 and c2 limit of csrc/attention.cu

launches = 0  # kernel launches since the last reset (ops/cuda/__init__.py)


def pooled_kv_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v with fp32 logits and softmax, p cast to v's dtype
    before p @ v, as the JAX kernel does."""
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkc->bqc", p.to(v.dtype), v)


def pooled_kv_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, C8), k (B, Nk, C8), v (B, Nk, C2) -> (B, Nq, C2): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]):
        raise ValueError(
            f"pooled_kv_attention: need q (B, Nq, C8), k (B, Nk, C8), "
            f"v (B, Nk, C2), got {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)}")
    if not _launch.runs_kernel("pooled_kv_attention", q, k, v):
        return pooled_kv_attention_plain(q, k, v)
    code = _launch.dtype_code("pooled_kv_attention", q, k, v)
    b, nq, c8 = q.shape
    nk, c2 = v.shape[1], v.shape[2]
    if c8 > MAX_CHANNELS or c2 > MAX_CHANNELS or b > 65535:
        raise ValueError(f"pooled_kv_attention: the kernel takes C8, C2 <= "
                         f"{MAX_CHANNELS} and B <= 65535, got B={b} C8={c8} "
                         f"C2={c2}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("pooled_kv_attention: q, k and v must be contiguous")
    out = torch.empty((b, nq, c2), dtype=v.dtype, device=v.device)
    check(library().spig_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, nq, nk, c8, c2, code, _launch.stream(q.device)),
        "pooled_kv_attention")
    launches += 1
    return out
