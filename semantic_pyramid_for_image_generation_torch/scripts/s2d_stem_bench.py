"""Microbenchmark of the exact space-to-depth rewrite of the 3-channel
256 x 256 input conv (3x3 SAME, 3 -> 64): the counterpart of the
repository's scripts/s2d_stem_bench.py for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.s2d_stem_bench \
        [--batch 128] [--iters 5] [--dtype bfloat16] [--device cuda]

The rewrite, with r = 2, of a 3x3 stride-1 SAME conv (B, 3, 256, 256) ->
(B, 64, 256, 256):

    space_to_depth  (B, 3, 256, 256) -> (B, 12, 128, 128), channel (u*2+v)*3+c
    pad             spatial 1 on each side
    conv 2x2 VALID  (256, 12, 2, 2) -> (B, 256, 129, 129), out (a*2+b)*64+o
    depth_from_phases: phase slices, depth to space -> (B, 64, 256, 256)

where the 2x2 kernel scatters the 3x3 taps (`scatter_kernel_s2d`):
K2[(a,b,o), (u,v,c), t, s] = k[o, c, a+u+2t-1, b+v+2s-1], zero out of range.
Output pixel (2i+a, 2j+b) reads input rows 2i+a+di-1 = 2(i+t')+u, so
di = a+u+2t-1 with t the tap on the padded s2d grid. The contraction widens
from 27 to 48 (16/9 of the true FLOPs: the 2x2 container carries zeros), and
the backward-to-input's output channels from 3 to 12.

Variants: `current` (the 3 channels padded to 8 inside, as the JAX VGG's
input conv), `s2d_onec` (one 2x2 conv over the padded s2d grid, four shifted
phase slices) and `s2d_fourc` (four 2x2 convs with per-phase padding). The
convolutions are cuDNN's (library calls), as the JAX script leaves them to
XLA.

Tensors are NCHW, kernels OIHW, where the JAX script's are NHWC / HWIO.
Prints each variant's float32 max |difference| from the direct SAME conv at
batch CHECK_BATCH, relative to its largest |output| (above TOLERANCE
raises), then its fwd+bwd ms per iteration
(grad-x and grad-k of mean(conv^2); CUDA events on the card, the host clock
with --device cpu), then one JSON line with both and the card (`nvidia-smi`
name and power limit; "cpu" with --device cpu).
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import sys
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.scripts.inputconv_bwd_bench import (
    grads,
    no_pad,
    pad_inside,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    exact_float32,
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.profiling import (
    iteration_ms,
)

IN_CHANNELS, OUT_CHANNELS, SIZE = 3, 64, 256
CHECK_BATCH = 2  # the float32 exactness check
# float32 max |difference| from the direct conv over its largest |output|:
# the rewrite sums the 27 products (and zeros) in another order, a few
# ulps (2^-23 = 1.2e-7 relative) at the largest outputs
TOLERANCE = 1e-6


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, r*r*C, H/r, W/r), channel (u*r+v)*C + c holds
    x[:, c, r*i+u, r*j+v]."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, r * r * c, h // r, w // r)


@functools.lru_cache(maxsize=None)
def _scatter_index() -> np.ndarray:
    """(a, b, u, v, t, s) -> the 3x3 tap (a+u+2t-1)*3 + (b+v+2s-1), or 9
    (a zero) out of range."""
    index = np.full((2,) * 6, 9, dtype=np.int64)
    for a, b, u, v, t, s in itertools.product(range(2), repeat=6):
        di, dj = a + u + 2 * t - 1, b + v + 2 * s - 1
        if 0 <= di < 3 and 0 <= dj < 3:
            index[a, b, u, v, t, s] = di * 3 + dj
    index.setflags(write=False)  # cached and shared by every caller
    return index


def scatter_kernel_s2d(k: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (4*Cout, 4*Cin, 2, 2), the phase scatter (see the
    module docstring), as one differentiable gather of k's 9 taps and a
    zero."""
    cout, cin, kh, kw = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"scatter_kernel_s2d: need a 3x3 kernel, got "
                         f"{tuple(k.shape)}")
    taps = F.pad(k.reshape(cout, cin, 9), (0, 1))  # tap 9 is the zero
    index = torch.tensor(_scatter_index(), device=k.device)
    k2 = taps[:, :, index]  # (o, c, a, b, u, v, t, s)
    return k2.permute(2, 3, 0, 4, 5, 1, 6, 7).reshape(4 * cout, 4 * cin, 2, 2)


def depth_from_phases(out: torch.Tensor, cout: int) -> torch.Tensor:
    """(B, 4*Cout, h+1, w+1) phase tensor -> (B, Cout, 2h, 2w):
    y[:, :, 2i+a, 2j+b] = out[:, (a*2+b)*Cout + o, i+a, j+b] (phase (a, b)'s
    h x w window starts at (a, b))."""
    h, w = out.shape[2] - 1, out.shape[3] - 1

    def phase(a: int, b: int) -> torch.Tensor:
        return out[:, (a * 2 + b) * cout:(a * 2 + b + 1) * cout,
                   a:a + h, b:b + w]

    return _interleave(phase, out.shape[0], cout, h, w)


def _interleave(phase: Callable[[int, int], torch.Tensor], batch: int,
                cout: int, h: int, w: int) -> torch.Tensor:
    """The four (B, Cout, h, w) phases -> (B, Cout, 2h, 2w), phase (a, b) at
    rows 2i+a, columns 2j+b."""
    y = torch.stack([torch.stack([phase(a, 0), phase(a, 1)], dim=-1)
                     for a in range(2)], dim=3)  # (B, Cout, h, 2, w, 2)
    return y.reshape(batch, cout, 2 * h, 2 * w)


def current(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The JAX VGG's input conv: 3 channels padded to 8 inside."""
    return pad_inside(x, k)


def s2d_onec(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One 2x2 conv over the padded s2d grid, four shifted phase slices."""
    xs = F.pad(space_to_depth(x), (1, 1, 1, 1))
    return depth_from_phases(F.conv2d(xs, scatter_kernel_s2d(k)), k.shape[0])


def s2d_fourc(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Four 2x2 convs, each with its phase's padding: no (h+1) grid."""
    cout = k.shape[0]
    xs, k2 = space_to_depth(x), scatter_kernel_s2d(k)

    def phase(a: int, b: int) -> torch.Tensor:
        return F.conv2d(F.pad(xs, (1 - b, b, 1 - a, a)),
                        k2[(a * 2 + b) * cout:(a * 2 + b + 1) * cout])

    return _interleave(phase, x.shape[0], cout, xs.shape[2], xs.shape[3])


VARIANTS: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "current": current, "s2d_onec": s2d_onec, "s2d_fourc": s2d_fourc}


def make_inputs(batch: int, dtype: torch.dtype, device: torch.device,
                seed: int = 0):
    """x (B, 3, 256, 256) and k (64, 3, 3, 3) ~ N(0, 1)."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((batch, IN_CHANNELS, SIZE, SIZE), generator=g,
                    device=device)
    k = torch.randn((OUT_CHANNELS, IN_CHANNELS, 3, 3), generator=g,
                    device=device)
    return x.to(dtype), k.to(dtype)


def float32_checks(device: torch.device) -> Dict[str, float]:
    """Each variant's max |difference| from the direct SAME conv over the
    direct conv's largest |output|, at batch CHECK_BATCH in float32."""
    x, k = make_inputs(CHECK_BATCH, torch.float32, device)
    with torch.no_grad(), exact_float32():
        want = no_pad(x, k)
        scale = want.abs().max()
        return {name: ((fn(x, k) - want).abs().max() / scale).item()
                for name, fn in VARIANTS.items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="the space-to-depth rewrite of the 3-channel input conv, "
                    "fwd+bwd, with a float32 exactness check")
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
    for name, err in checks.items():
        print(f"{name:12s} float32 max|diff| vs direct conv (relative): "
              f"{err:.3e}", flush=True)
    if max(checks.values()) > TOLERANCE:
        raise AssertionError(f"a variant differs from the direct conv beyond "
                             f"{TOLERANCE:g}: {checks}")
    x, k = make_inputs(args.batch, getattr(torch, args.dtype), device)
    ms = {}
    with exact_float32():
        for name, fn in VARIANTS.items():
            ms[name] = iteration_ms(functools.partial(grads, fn, x, k),
                                    device, args.iters)
            print(f"{name:12s} fwd+bwd {ms[name]:8.2f} ms/iter", flush=True)
    print(json.dumps({
        "script": "s2d_stem_bench", "batch": args.batch,
        "dtype": args.dtype, "iters": args.iters,
        "float32_rel_err_vs_direct": checks, "tolerance": TOLERANCE,
        "ms_per_iter": ms,
        "card": card_line() if device.type == "cuda" else "cpu"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
