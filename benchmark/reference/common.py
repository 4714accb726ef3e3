"""What the plain references share: the precision a reference computes in,
spectral normalization and Adam.

Plain PyTorch in float32 with TF32 off. Every function is pure: the state a
training forward advances (the spectral u/v, the running statistics) comes
in as arguments and goes out as results, so a block can be recomputed by
`torch.utils.checkpoint` without advancing anything twice.

`Precision` is the one switch: "float32" is the reference; "fp8" rounds each
operand of every convolution, dense layer and attention product to
float8_e4m3 (per-tensor scale, straight-through gradient), the control that
a lower precision than the configuration's must fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn
EPS = 1e-12


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Precision:
    """Rounds the operands of the products: identity at "float32"."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8: {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        scale = x.detach().abs().amax().clamp(min=EPS) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self(x), self(w), b, stride=stride, padding=padding)

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=EPS)


def spectral_weight(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    iterate: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w / sigma, u, v) of torch's spectral norm on the (out, rest) view:
    with `iterate`, one power-iteration step first (a training forward);
    sigma = u^T W v with u, v held constant."""
    m = w.reshape(w.shape[0], -1)
    if iterate:
        with torch.no_grad():
            v = l2_normalize(m.T @ u)
            u = l2_normalize(m @ v)
    sigma = torch.einsum("i,ij,j->", u.detach(), m, v.detach())
    return w / sigma, u, v


def adam_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]], step: int,
          lr: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> None:
    """One Adam update of `params` in place (torch's formula, no weight
    decay) at step `step` (1 for the first); `moments` holds (m, v) per key
    and is updated in place. A key without a gradient is left alone."""
    for key, g in grads.items():
        if g is None:
            continue
        m, v = moments.get(key, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        moments[key] = (m, v)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** step)) + eps
        params[key] = (params[key] - (lr / (1.0 - b1 ** step)) * m / denom
                       ).detach()

