"""FID-10k rehearsal on the card, counterpart of the repository's
scripts/fid_rehearsal.py for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.fid_rehearsal \
        [--num 10000] [--batch 64] [--stage 16] [--dtype bfloat16]

Runs the whole FID pipeline at 10k images: the full-width VGG-16 pyramid
and Generator make the fakes (the port's kernels), a random-init Inception
(loaded through the torchvision-named state-dict path the real weights
take) gives the real and fake activations at 299 in float32, their
moments accumulate on the card, and the FID is reduced twice, on the host
(float64 scipy sqrtm) and on the card (float32 eigh). It prints one JSON
line: both FIDs, the images, the batch, the seconds of the moments pass and
of each reduction, images/s (real + fake), peak memory and the card's name
and power limit. The images are synthetic (`--stage` device-resident
batches of data/synthetic.py, cycled); every compute stage is the
production one. Batches are walked one by one, as Trainer.validate does;
the JAX script's single-dispatch scan has no counterpart here.

The parts are functions (`build`, `stage_batches`, `moments_pass`,
`host_statistics`, `device_statistics`), so a test can pin the latents.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.eval.fid import (
    FIDEvaluator,
    Moments,
    fid_from_moments_device,
    fid_from_statistics,
    statistics_from_moments,
)
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.models.inception import (
    make_inception,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_generate_fn,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    resolve_device,
)

LATENT_SEED = 7  # the latents' torch.Generator (the JAX script's key(7))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FID-10k rehearsal on the card")
    p.add_argument("--num", type=int, default=10_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--stage", type=int, default=16,
                   help="distinct device-resident batches to cycle")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def build(config: PyramidGANConfig, device: torch.device
          ) -> Tuple[Callable, FIDEvaluator]:
    """The eval-mode generate of G and the VGG-16 and the FID evaluator,
    all random-init from seed 0."""
    generator, vgg = make_models(
        config, device, rng=torch.Generator(device).manual_seed(0))
    inception = make_inception(
        device, rng=torch.Generator(device).manual_seed(0))
    return (make_generate_fn(generator, vgg),
            FIDEvaluator(inception.state_dict(), device))


def stage_batches(config: PyramidGANConfig, batch: int, n_stage: int,
                  device: torch.device,
                  rng: np.random.Generator) -> List[Dict]:
    """`n_stage` validation-mask synthetic batches on `device`."""
    return [batch_to_device(synthetic_batch(config, batch, rng,
                                            validation=True), device)
            for _ in range(n_stage)]


def latent_stream(config: PyramidGANConfig, batch: int,
                  device: torch.device,
                  seed: int = LATENT_SEED) -> Callable[[int], torch.Tensor]:
    """latents(i): batch i's (batch, latent_dim) draw from one explicit
    torch.Generator (call in order)."""
    rng = torch.Generator(device).manual_seed(seed)
    return lambda i: torch.randn((batch, config.latent_dim), generator=rng,
                                 device=device)


def moments_pass(generate_fn: Callable, evaluator: FIDEvaluator,
                 staged: Sequence[Dict], n_batches: int,
                 latents: Callable[[int], torch.Tensor]
                 ) -> Tuple[int, Moments]:
    """Batch i (staged[i % len(staged)]): generate with latents(i), then the
    real and the fake moments; returns (count, (sum, outer) real, (sum,
    outer) fake), summed on the device."""
    n, totals = 0, None
    for i in range(n_batches):
        batch = staged[i % len(staged)]
        rows = batch["images"].shape[0]
        fakes = generate_fn(batch["images"], batch["masks"], batch["labels"],
                            latents(i))
        new = (*evaluator.moments(batch["images"], rows),
               *evaluator.moments(fakes, rows))
        totals = new if totals is None else tuple(
            a + b for a, b in zip(totals, new))
        n += rows
    return n, totals


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_statistics(n: int, totals: Moments) -> Tuple[float, float]:
    """(FID, seconds): the moments copied to the host, float64 statistics,
    scipy's sqrtm."""
    start = time.perf_counter()
    s1r, s2r, s1f, s2f = (t.double().cpu().numpy() for t in totals)
    mu_r, cov_r = statistics_from_moments(n, s1r, s2r)
    mu_f, cov_f = statistics_from_moments(n, s1f, s2f)
    fid = fid_from_statistics(mu_r, cov_r, mu_f, cov_f)
    return fid, time.perf_counter() - start


def device_statistics(n: int, totals: Moments) -> Tuple[float, float]:
    """(FID, seconds) of the float32 reduction on the moments' device, one
    scalar back; timed on its second call (the first sets the solver up)."""
    first = float(fid_from_moments_device(n, *totals))
    if not np.isfinite(first):
        raise FloatingPointError(f"device FID {first}")
    start = time.perf_counter()
    fid = float(fid_from_moments_device(n, *totals))
    return fid, time.perf_counter() - start


def memory(device: torch.device) -> Dict[str, int]:
    if device.type != "cuda":
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "memory_reserved": torch.cuda.memory_reserved(device),
            "total_memory":
                torch.cuda.get_device_properties(device).total_memory}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = PyramidGANConfig(compute_dtype=args.dtype)

    start = time.perf_counter()
    generate_fn, evaluator = build(config, device)
    n_batches = -(-args.num // args.batch)
    staged = stage_batches(config, args.batch, min(n_batches, args.stage),
                           device, np.random.default_rng(0))
    # one batch first: builds the kernels and warms the convolutions
    moments_pass(generate_fn, evaluator, staged, 1,
                 latent_stream(config, args.batch, device))
    _sync(device)
    print(f"setup and first batch {time.perf_counter() - start:.1f}s",
          flush=True)

    start = time.perf_counter()
    n, totals = moments_pass(generate_fn, evaluator, staged, n_batches,
                             latent_stream(config, args.batch, device))
    _sync(device)
    wall = time.perf_counter() - start
    fid, host_s = host_statistics(n, totals)
    fid_dev, device_s = device_statistics(n, totals)
    print(f"stats host {host_s:.1f}s (fid={fid:.4f})  device "
          f"{device_s:.3f}s (fid={fid_dev:.4f})", flush=True)
    print(json.dumps({
        "metric": f"FID-{n} rehearsal wall-clock (VGG+G+Inception on the "
                  "card, batch by batch; sqrtm on the host, eigh on the card)",
        "fid": fid,
        "fid_device_stats": fid_dev,
        "images": n,
        "batch": args.batch,
        "wall_s": wall,
        "stats_host_s": host_s,
        "stats_device_s": device_s,
        "images_per_sec": 2 * n / wall,  # real + fake passes
        "memory": memory(device),
        "card": card_line() if device.type == "cuda" else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
