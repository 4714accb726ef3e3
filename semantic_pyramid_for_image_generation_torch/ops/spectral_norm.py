"""Spectral normalization on the (out, in*kh*kw) view of a torch weight.

Counterpart of the JAX package's ops/spectral_norm.py. torch's
`nn.utils.spectral_norm` keeps `weight_orig`, `weight_u` and `weight_v`; the
port keeps the same three tensors under the same names, so reference and
JAX-exported state dicts load unchanged. Eval mode reuses the stored u/v:
sigma = u^T W v. The one power-iteration step is here for the training
slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def l2_normalize(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """`torch.nn.functional.normalize` of a vector: x / max(||x||_2, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """The matrix torch iterates on: OIHW -> (O, I*kh*kw); (out, in) as is."""
    return weight.reshape(weight.shape[0], -1)


@torch.no_grad()
def power_iteration(w2d: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    n_iter: int = 1, eps: float = _EPS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n_iter` steps of v <- normalize(W^T u); u <- normalize(W v)."""
    w32 = w2d.float()
    for _ in range(n_iter):
        v = l2_normalize(w32.T @ u, eps)
        u = l2_normalize(w32 @ v, eps)
    return u, v


def spectral_norm_weight(w2d: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         update: bool, n_iter: int = 1, eps: float = _EPS
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sigma, u, v) for one weight matrix: with `update`, run `n_iter` power
    iterations first (training-mode forward); else reuse u/v (eval). sigma is
    differentiable in W with u/v held constant (d sigma / dW = u v^T)."""
    if update:
        u, v = power_iteration(w2d, u, v, n_iter, eps)
    u, v = u.detach(), v.detach()
    sigma = torch.einsum("i,ij,j->", u, w2d.float(), v)
    return sigma, u, v
