"""Microbenchmark of the generator's final-block chain, upsample x2 -> BN ->
LeakyReLU -> 3x3 conv, forward and backward: the counterpart of the
repository's scripts/finalblock_bench.py for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.finalblock_bench \
        [--batch 128] [--iters 5] [--dtype bfloat16] [--device cuda]

The question the JAX script asks: can the BN statistics of up2(x) be
computed from x, through the interpolation matrices' column sums (the mean)
and Gram matrices (E[y^2]), instead of reducing over the 4x larger
upsampled tensor? `upsample2_stats` is that algebra; `chain_current` takes
the statistics of the upsampled tensor, as `Generator.final_block` does
(models/generator.py), and `chain_folded` takes them from x. Both upsample
through the port's `Upsample2xFunction` (ops/cuda/resize.py): Kernel 3
forward and Kernel 5 backward on the card, their plain versions on the CPU.

Tensors are NCHW (x (B, 64, 128, 128), the kernel (64, 64, 3, 3) OIHW) where
the JAX script's are NHWC / HWIO. Prints the stats agreement at --dtype, the
float32 checks at batch CHECK_BATCH (the stats against the direct ones within
STATS_TOLERANCE, and the two chains' loss and gradients against each other
within CHAIN_TOLERANCE; a miss raises), ms per iteration of grad-x and
grad-kernel of each chain (CUDA events on the card; the host clock with
--device cpu), then one JSON line with those numbers, the card (`nvidia-smi`
name and power limit; "cpu" with --device cpu) and each chain's port-kernel
launches per iteration.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.ops.resize import (
    _bilinear_matrix_align_corners,
    upsample_bilinear_align_corners,
)
from semantic_pyramid_for_image_generation_torch.scripts.inputconv_bwd_bench import (
    max_rel_err,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    exact_float32,
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import (
    iteration_ms,
    launches_of,
)

CHANNELS, SIZE = 64, 128  # the final block's input: (B, 64, 128, 128)
CHECK_BATCH = 2  # the float32 checks
STATS_TOLERANCE = 1e-5  # float32: |mean err| and relative meansq err
CHAIN_TOLERANCE = 1e-4  # float32: folded against current, relative


@functools.lru_cache(maxsize=None)
def _stats_weights(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(column sums (H,), Gram matrix A^T A (H, H), tridiagonal) of the
    (2H, H) align-corners interpolation matrix A."""
    a = _bilinear_matrix_align_corners(size, 2 * size)
    s, g = a.sum(0), a.T @ a
    s.setflags(write=False)  # cached and shared by every caller
    g.setflags(write=False)
    return s, g


def upsample2_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_c, meansq_c) of the 2x align-corners upsample of x (B, C, H, W),
    in float32, computed from x: sum(up(x)) = s_h^T x s_w and
    sum(up(x)^2) = <x, G_h x G_w>. The partial products are rounded to x's
    dtype and the two reductions taken in float32, as the JAX script's
    einsums with float32 accumulation do."""
    b, _, h, w = x.shape
    (s_h, g_h), (s_w, g_w) = (
        (torch.tensor(a, dtype=x.dtype, device=x.device) for a in
         _stats_weights(n)) for n in (h, w))
    n = b * (2 * h) * (2 * w)
    xs = torch.einsum("h,bchw->bcw", s_h, x)
    mean = torch.einsum("w,bcw->c", s_w.float(), xs.float()) / n
    gx = torch.einsum("ih,bchw->bciw", g_h, x)
    gxw = torch.einsum("jw,bciw->bcij", g_w, gx)
    meansq = torch.einsum("bcij,bcij->c", x.float(), gxw.float()) / n
    return mean, meansq


def _normalize_and_convolve(y: torch.Tensor, mean: torch.Tensor,
                            var: torch.Tensor, kernel: torch.Tensor,
                            scale: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """BN with the given statistics, LeakyReLU(0.2), the 3x3 SAME conv, and
    the loss mean(out^2) in float32."""
    inv = torch.rsqrt(var + 1e-5) * scale
    y = ((y.float() - mean[:, None, None]) * inv[:, None, None]
         + bias[:, None, None]).to(y.dtype)
    y = torch.where(y > 0, y, 0.2 * y)
    y = F.conv2d(y, kernel, padding=1)
    return torch.mean(y.float() ** 2)


def chain_current(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The statistics reduced over the upsampled tensor."""
    y = upsample_bilinear_align_corners(x)
    y32 = y.float()
    mean = y32.mean((0, 2, 3))
    var = (y32 ** 2).mean((0, 2, 3)) - mean ** 2
    return _normalize_and_convolve(y, mean, var, kernel, scale, bias)


def chain_folded(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The statistics computed from x (`upsample2_stats`)."""
    mean, meansq = upsample2_stats(x)
    y = upsample_bilinear_align_corners(x)
    return _normalize_and_convolve(y, mean, meansq - mean ** 2, kernel,
                                   scale, bias)


CHAINS: Dict[str, Callable[..., torch.Tensor]] = {
    "current": chain_current, "folded": chain_folded}


def loss_and_grads(chain: Callable[..., torch.Tensor], x: torch.Tensor,
                   kernel: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, d loss / d x, d loss / d kernel) of one chain."""
    x, kernel = (t.detach().requires_grad_() for t in (x, kernel))
    loss = chain(x, kernel, scale, bias)
    gx, gk = torch.autograd.grad(loss, (x, kernel))
    return loss.detach(), gx, gk


def make_inputs(batch: int, dtype: torch.dtype, device: torch.device,
                seed: int = 0):
    """x (B, 64, 128, 128) ~ N(0, 1) channels_last, the kernel ~ N(0, 0.05^2),
    scale ones and bias zeros in float32."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((batch, CHANNELS, SIZE, SIZE), generator=g,
                    device=device).to(dtype)
    kernel = (torch.randn((CHANNELS, CHANNELS, 3, 3), generator=g,
                          device=device) * 0.05).to(dtype)
    scale = torch.ones(CHANNELS, device=device)
    bias = torch.zeros(CHANNELS, device=device)
    return (x.contiguous(memory_format=torch.channels_last), kernel, scale,
            bias)


def stats_agreement(x: torch.Tensor) -> Dict[str, float]:
    """The folded statistics against those of the upsampled tensor: max
    |mean err| and max relative meansq err over the channels."""
    y = upsample_bilinear_align_corners(x).float()
    m_direct = y.mean((0, 2, 3))
    s_direct = (y ** 2).mean((0, 2, 3))
    m_fold, s_fold = upsample2_stats(x)
    return {"mean_abs_err": (m_fold - m_direct).abs().max().item(),
            "meansq_rel_err": ((s_fold - s_direct).abs()
                               / s_direct.clamp_min(1e-6)).max().item()}


def float32_checks(device: torch.device) -> Dict[str, float]:
    """At batch CHECK_BATCH in float32: the stats agreement, and the folded
    chain's loss and gradients against the current chain's (relative)."""
    inputs = make_inputs(CHECK_BATCH, torch.float32, device)
    with exact_float32():
        check = {f"stats_{k}": v
                 for k, v in stats_agreement(inputs[0]).items()}
        want = loss_and_grads(chain_current, *inputs)
        got = loss_and_grads(chain_folded, *inputs)
    for name, a, b in zip(("loss", "grad_x", "grad_kernel"), got, want):
        check[f"folded_{name}_rel_err"] = max_rel_err(a, b)
    return check


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="G final-block chain fwd+bwd: BN statistics folded "
                    "through the interpolation matrices against reduced")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    checks = float32_checks(device)
    inputs = make_inputs(args.batch, dtype, device)
    with exact_float32():
        stats = stats_agreement(inputs[0])
    print(f"stats agreement: |mean err| {stats['mean_abs_err']:.3e}  rel "
          f"meansq err {stats['meansq_rel_err']:.3e}", flush=True)
    print(f"float32, batch {CHECK_BATCH}: stats |mean err| "
          f"{checks['stats_mean_abs_err']:.3e}, rel meansq err "
          f"{checks['stats_meansq_rel_err']:.3e} (tolerance "
          f"{STATS_TOLERANCE:g}); folded against current: loss "
          f"{checks['folded_loss_rel_err']:.3e}, grad-x "
          f"{checks['folded_grad_x_rel_err']:.3e}, grad-kernel "
          f"{checks['folded_grad_kernel_rel_err']:.3e} (tolerance "
          f"{CHAIN_TOLERANCE:g})", flush=True)
    if max(checks["stats_mean_abs_err"],
           checks["stats_meansq_rel_err"]) > STATS_TOLERANCE \
            or max(v for k, v in checks.items()
                   if k.startswith("folded")) > CHAIN_TOLERANCE:
        raise AssertionError(f"the float32 checks failed: {checks}")
    ms, launches = {}, {}
    with exact_float32():
        for name, chain in CHAINS.items():
            run = functools.partial(loss_and_grads, chain, *inputs)
            launches[name] = launches_of(run)
            ms[name] = iteration_ms(run, device, args.iters)
            print(f"{name:10s} {ms[name]:8.2f} ms/iter (fwd+bwd)", flush=True)
    print(json.dumps({
        "script": "finalblock_bench", "batch": args.batch,
        "dtype": args.dtype, "iters": args.iters, "stats": stats,
        "float32_checks": checks, "ms_per_iter": ms,
        "launches_per_iter": launches,
        "card": card_line() if device.type == "cuda" else "cpu"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
