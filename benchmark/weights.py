"""Weights made from the seed on the device, for the program and the
reference alike.

A spec maps each state-dict key to (shape, initializer). Every leaf of one
initializer is cut from one large draw of a generator on the device, so a
network's weights take a handful of calls, not one per leaf. Spectral
vectors are brought near the layer's top singular vectors by a few power
iterations, as a trained model's are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

POWER_ITERATIONS = 10
UNIFORM = ("xavier",)
NORMAL = ("kaiming", "dense", "normal", "unit", "cbn", "running_mean",
          "running_var")


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def _scale(kind: str, shape) -> float:
    if kind == "xavier":  # U(-a, a) from U(-1, 1)
        fan_in, fan_out = _fans(shape)
        return math.sqrt(6.0 / (fan_in + fan_out))
    if kind == "kaiming":  # torchvision's VGG: N(0, 2 / fan_out)
        return math.sqrt(2.0 / _fans(shape)[1])
    if kind == "dense":  # torchvision's VGG classifier: N(0, 0.01^2)
        return 0.01
    if kind in ("cbn", "running_mean", "running_var"):
        return 0.1
    return 1.0


def make_weights(spec: Dict[str, tuple], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """A float32 tensor per key of `spec` (int64 zeros for "count")."""
    rng = torch.Generator(device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kinds, draw in ((UNIFORM, lambda n: torch.rand(
            n, generator=rng, device=device) * 2 - 1),
                        (NORMAL, lambda n: torch.randn(
            n, generator=rng, device=device))):
        keys = [k for k, (_, kind) in spec.items() if kind in kinds]
        sizes = [math.prod(spec[k][0]) for k in keys]
        if not keys:
            continue
        scales = torch.tensor([_scale(spec[k][1], spec[k][0]) for k in keys],
                              device=device)
        flat = draw(sum(sizes)) * torch.repeat_interleave(
            scales, torch.tensor(sizes, device=device))
        for key, piece in zip(keys, torch.split(flat, sizes)):
            out[key] = piece.view(spec[key][0])
    for key, (shape, kind) in spec.items():
        if kind == "zeros":
            out[key] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[key] = torch.ones(shape, device=device)
        elif kind == "count":
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "unit":
            out[key] = out[key] / out[key].norm().clamp(min=1e-12)
        elif kind == "cbn":  # per-class (scale, bias) rows near (1, 0)
            half = shape[1] // 2
            out[key][:, :half] += 1.0
        elif kind == "running_var":
            out[key] = out[key].exp()
    _converge_spectral(out)
    return {k: out[k] for k in spec}


@torch.no_grad()
def _converge_spectral(weights: Dict[str, torch.Tensor]) -> None:
    for key in [k for k in weights if k.endswith(".weight_orig")]:
        name = key[:-len(".weight_orig")]
        m = weights[key].reshape(weights[key].shape[0], -1)
        u, v = weights[f"{name}.weight_u"], weights[f"{name}.weight_v"]
        for _ in range(POWER_ITERATIONS):
            v = m.T @ u
            v = v / v.norm().clamp(min=1e-12)
            u = m @ v
            u = u / u.norm().clamp(min=1e-12)
        weights[f"{name}.weight_u"], weights[f"{name}.weight_v"] = u, v
