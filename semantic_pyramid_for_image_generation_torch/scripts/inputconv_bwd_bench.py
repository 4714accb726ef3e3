"""Microbenchmark of exact formulations of the image-input convolution
(VGG-16 `features.0`: 3 -> 64 channels, 3x3 SAME, 256 x 256) forward and
backward: the counterpart of the repository's scripts/inputconv_bwd_bench.py
for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.inputconv_bwd_bench \
        [--batch 128] [--iters 5] [--dtype bfloat16] [--device cuda]

The JAX VGG pads the 3 image channels to 8 inside its input conv; the
port's `Conv3x3` convolves the 3 channels (models/vgg16.py). Four variants
of the same function, each timed as grad-x and grad-k of mean(conv(x, k)^2)
(the input gradient flows into G's fakes in the train step, the kernel
gradient exists for the fine-tune):
  * `pad_inside`  - x and k padded 3 -> 8 channels inside (the JAX VGG);
  * `no_pad`      - the 3-channel conv (the port's VGG);
  * `pad_outside` - the caller keeps an 8-channel image, k padded;
  * `custom`      - `pad_inside` with its backward written out as two
    convolutions (`SplitBackwardConv`): grad-x with the flipped, transposed
    kernel (64 -> 8, then sliced to 3) and grad-k with the batch as the
    contraction.
The convolutions are cuDNN's (library calls): the JAX script leaves them to
XLA, none is a Pallas kernel.

Tensors are NCHW, kernels OIHW, where the JAX script's are NHWC / HWIO.
Prints each variant's float32 gradients against `no_pad`'s at batch
CHECK_BATCH (relative to the largest |gradient|; above TOLERANCE raises),
then its ms per iteration at --batch and --dtype (CUDA events on the card;
the host clock with --device cpu), then one JSON line with both and the
card (`nvidia-smi` name and power limit; "cpu" with --device cpu).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    exact_float32,
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import (
    iteration_ms,
)

IN_CHANNELS, PADDED, OUT_CHANNELS, SIZE = 3, 8, 64, 256
CHECK_BATCH = 2  # the float32 check against no_pad
# float32, relative to the largest |gradient|: the same sums in another
# order. grad-x sums 64 x 9 products an element; grad-k sums B x 256 x 256
# (131,072 at CHECK_BATCH), whose rounding in another order reaches
# ~sqrt(n) x 2^-24 = 2e-5 of the terms' scale
TOLERANCE = {"grad_x": 1e-5, "grad_k": 1e-4}


def _pad_channels(t: torch.Tensor) -> torch.Tensor:
    """Dim 1 (channels of x, input channels of k) zero-padded to PADDED."""
    return F.pad(t, (0, 0, 0, 0, 0, PADDED - t.shape[1]))


def pad_inside(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv2d(_pad_channels(x), _pad_channels(k), padding=1)


def no_pad(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, k, padding=1)


def pad_outside(x8: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x8: the image already padded to PADDED channels by the caller."""
    return F.conv2d(x8, _pad_channels(k), padding=1)


class SplitBackwardConv(torch.autograd.Function):
    """`pad_inside` with its backward as two explicit convolutions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, k)
        return pad_inside(x, k)

    @staticmethod
    def backward(ctx, gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, k = ctx.saved_tensors
        cin = x.shape[1]
        # grad-x: the transposed conv as a conv with the flipped kernel,
        # in and out channels swapped, (8, 64, 3, 3); then sliced to 3
        kt = _pad_channels(k).flip(2, 3).transpose(0, 1)
        gx = F.conv2d(gy, kt, padding=1)[:, :cin]
        # grad-k: the channels of x as the batch, the batch as the
        # contraction, gy as a (64, B, H, W) kernel -> (8, 64, 3, 3)
        gk = F.conv2d(_pad_channels(x).transpose(0, 1), gy.transpose(0, 1),
                      padding=1)
        return gx, gk.transpose(0, 1)[:, :cin]


def custom(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return SplitBackwardConv.apply(x, k)


VARIANTS: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "pad_inside": pad_inside, "no_pad": no_pad, "pad_outside": pad_outside,
    "custom": custom}


def make_variants(batch: int, dtype: torch.dtype, device: torch.device,
                  seed: int = 0) -> Dict[str, Tuple[Callable, torch.Tensor,
                                                    torch.Tensor]]:
    """{name: (fn, x, k)}: x (B, 3, 256, 256) and k (64, 3, 3, 3) ~ N(0, 1)
    (`pad_outside` gets x padded to 8 channels)."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((batch, IN_CHANNELS, SIZE, SIZE), generator=g,
                    device=device).to(dtype)
    k = torch.randn((OUT_CHANNELS, IN_CHANNELS, 3, 3), generator=g,
                    device=device).to(dtype)
    return {name: (fn, _pad_channels(x) if name == "pad_outside" else x, k)
            for name, fn in VARIANTS.items()}


def grads(fn: Callable, x: torch.Tensor,
          k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad-x, grad-k) of mean(fn(x, k)^2), the loss in float32."""
    x, k = (t.detach().requires_grad_() for t in (x, k))
    loss = torch.mean(fn(x, k).float() ** 2)
    return torch.autograd.grad(loss, (x, k))


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def float32_checks(device: torch.device) -> Dict[str, Dict[str, float]]:
    """Each variant's grad-x (its first 3 channels) and grad-k against
    no_pad's, relative, at batch CHECK_BATCH in float32."""
    variants = make_variants(CHECK_BATCH, torch.float32, device)
    with exact_float32():
        want = grads(*variants["no_pad"])
        checks = {}
        for name, args in variants.items():
            gx, gk = grads(*args)
            checks[name] = {
                "grad_x": max_rel_err(gx[:, :IN_CHANNELS], want[0]),
                "grad_k": max_rel_err(gk, want[1])}
    return checks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="the image-input conv's fwd+bwd in four exact "
                    "formulations")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    checks = float32_checks(device)
    for name, check in checks.items():
        print(f"{name:12s} float32 max|diff| vs no_pad (relative): grad-x "
              f"{check['grad_x']:.3e}, grad-k {check['grad_k']:.3e}",
              flush=True)
    if any(c[g] > TOLERANCE[g] for c in checks.values() for g in TOLERANCE):
        raise AssertionError(f"a variant's float32 gradients differ from "
                             f"no_pad's beyond {TOLERANCE}: {checks}")
    ms = {}
    variants = make_variants(args.batch, getattr(torch, args.dtype), device)
    with exact_float32():
        for name, (fn, x, k) in variants.items():
            ms[name] = iteration_ms(functools.partial(grads, fn, x, k),
                                    device, args.iters)
            print(f"{name:12s} {ms[name]:8.2f} ms/iter", flush=True)
    print(json.dumps({
        "script": "inputconv_bwd_bench", "batch": args.batch,
        "dtype": args.dtype, "iters": args.iters,
        "float32_rel_err_vs_no_pad": checks, "tolerance": TOLERANCE,
        "ms_per_iter": ms,
        "card": card_line() if device.type == "cuda" else "cpu"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
