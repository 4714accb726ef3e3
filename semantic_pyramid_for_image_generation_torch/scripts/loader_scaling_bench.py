"""Host input-pipeline worker scaling against the card's own step rate,
counterpart of the repository's scripts/loader_scaling_bench.py for the
PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.loader_scaling_bench \
        [--workers 1,2,4,8] [--batch 64] [--images 512] [--float_feed]

On a synthetic Places365-format JPEG tree (scripts/jpeg_tree.py, 4
classes) in a temporary directory, for each worker count:
  * `loader` - the production `Places365Loader` (threaded PIL decode, the
    native mask kernels when the native library builds, collate)
    in the compact uint8 feed (float32 with --float_feed): best of 2
    passes after a warm-up batch, images/s;
  * `decode` - a pure ThreadPoolExecutor PIL decode of the same files,
    best of 2, images/s: the codec's thread scaling alone.
One JSON line per worker count, then a `summary` line: the host's cores,
the feed, the decode speedup at its peak, and the rate the loader must
beat for the feed not to bound training: `device_rate_to_beat_img_per_s`,
measured here as the median images/s of full-width default-mode bf16
`make_train_step` steps at `--batch` on the card (`device_step_rate`,
which runs all five kernels). The summary adds the card (`nvidia-smi`
name and power limit; "cpu" with --device cpu) and `mask_route`:
"native" when the loader drew its masks with the native kernel, "numpy"
when the library could not be built and it used data/masks.py.

The parts are functions (`decode_throughput`, `make_loader`,
`loader_throughput`, `device_step_rate`, `run`), so a test can drive them
at tiny widths.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data import native
from semantic_pyramid_for_image_generation_torch.data.places365 import (
    Places365,
    Places365Loader,
)
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
    make_jpeg_tree,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_train_step,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    resolve_device,
)

CLASSES = 4
WARMUP, STEPS = 2, 5  # device_step_rate's untimed and timed steps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="host feed worker scaling against the card's step rate")
    p.add_argument("--workers", default="1,2,4,8",
                   help="comma-separated worker counts to sweep")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--images", type=int, default=512,
                   help="synthetic JPEG count (Places365-format tree)")
    p.add_argument("--float_feed", action="store_true",
                   help="bench the float32 feed instead of uint8 compact")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def decode_throughput(paths, workers: int, repeats: int = 2) -> float:
    """Pure PIL open+decode+to-array rate (img/s) at `workers` threads."""
    from PIL import Image

    def decode(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB")).shape

    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(decode, paths))
        best = max(best, len(paths) / (time.perf_counter() - t0))
    return best


def make_loader(root: str, config: PyramidGANConfig, batch: int,
                workers: int, compact: bool,
                use_native_masks: Optional[bool] = None) -> Places365Loader:
    """The production loader over `root`/train.txt, as the bench times it
    (`use_native_masks` None: the native masks when the library builds)."""
    return Places365Loader(Places365(root, "train.txt", config),
                           batch_size=batch, num_workers=workers, prefetch=2,
                           compact_feed=compact,
                           use_native_masks=use_native_masks)


def loader_throughput(root: str, config: PyramidGANConfig, batch: int,
                      workers: int, compact: bool) -> float:
    """Best of 2 passes of `make_loader`'s loader (img/s), after one batch
    that warms the page cache and the thread pool."""
    loader = make_loader(root, config, batch, workers, compact)
    for _ in loader:
        break
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        n = 0
        for b in loader:
            n += b["images"].shape[0]
        best = max(best, n / (time.perf_counter() - t0))
    return best


def device_step_rate(config: PyramidGANConfig, batch: int,
                     device: torch.device, dtype: str = "bfloat16",
                     warmup: int = WARMUP, steps: int = STEPS) -> float:
    """Median images/s of default-mode `make_train_step` steps at `batch`
    on `device` (host clock, synchronized after each step), from a random
    init (seed 0) on one synthetic batch already on the device."""
    config = dataclasses.replace(config, compute_dtype=dtype)
    state = init_train_state(config, device)
    step = make_train_step()
    data = batch_to_device(
        synthetic_batch(config, batch, np.random.default_rng(0)), device)
    rng = torch.Generator(device).manual_seed(0)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rates = []
    for i in range(warmup + steps):
        sync()
        t0 = time.perf_counter()
        _, metrics = step(state, data, rng)
        sync()
        if i >= warmup:
            rates.append(batch / (time.perf_counter() - t0))
    losses = [float(v) for v in metrics.values()]
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite losses {losses}")
    return statistics.median(rates)


def run(args: argparse.Namespace, config: PyramidGANConfig,
        warmup: int = WARMUP, steps: int = STEPS) -> Tuple[List[Dict], Dict]:
    """The sweep, then the device rate at `config`; prints and returns the
    rows and the summary."""
    device = resolve_device(args.device)
    worker_counts = [int(w) for w in args.workers.split(",")]
    with tempfile.TemporaryDirectory() as root:
        make_jpeg_tree(root, config.image_size,
                       per_class=-(-args.images // CLASSES), classes=CLASSES)
        with open(os.path.join(root, "train.txt")) as f:
            paths = [os.path.join(root, ln.strip()) for ln in f if ln.strip()]
        rows = []
        for w in worker_counts:
            dec = decode_throughput(paths, w)
            ldr = loader_throughput(root, config, args.batch, w,
                                    compact=not args.float_feed)
            row = {"num_workers": w, "decode_img_per_s": round(dec, 1),
                   "loader_img_per_s": round(ldr, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    rate = device_step_rate(config, args.batch, device, warmup=warmup,
                            steps=steps)
    base = rows[0]
    peak = max(rows, key=lambda r: r["decode_img_per_s"])
    summary = {
        "summary": "host feed worker scaling",
        "cpu_count": os.cpu_count(),
        "feed": "float32" if args.float_feed else "uint8-compact",
        "decode_speedup_at_peak": round(
            peak["decode_img_per_s"] / base["decode_img_per_s"], 2),
        "peak_workers": peak["num_workers"],
        "device_rate_to_beat_img_per_s": round(rate, 1),
        "card": card_line() if device.type == "cuda" else "cpu",
        "mask_route": "native" if native.native_available() else "numpy",
    }
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None) -> int:
    run(build_parser().parse_args(argv), PyramidGANConfig())
    return 0


if __name__ == "__main__":
    sys.exit(main())
