#!/usr/bin/env python3
"""Splits the bf16 train step's rate on one card by what feeds it, and
prints one JSON object.

    python tests/torch_feed_split.py [--classes 4] [--out FILE]

(`--device cpu --tiny --per_class 8` rehearses it on the CPU at the
width factors 8.)

Full width, default mode, batch 64, random init from seed 0, through
`Trainer.train_step` (the step Trainer.train takes: it copies each batch
to the card) with the step metrics fetched every 50 steps, as
Trainer.train does. The batches come from a synthetic Places365-format
tree (scripts/jpeg_tree.py, `--classes` x `--per_class` JPEGs: 1,024,
16 steps of 64 a class) in a temporary directory. Each case runs one epoch of those steps
and reads images/s on the host clock, from before the first step to a
`torch.cuda.synchronize()` after the last, with two more numbers: the
seconds the step loop waited for its next batch, and the main thread's
CPU seconds (`time.thread_time`). The cases:
  * `device`: one batch already on the card, every step (the same step
    without the copy);
  * `host`: the epoch's loader batches (compact uint8), collected in host
    memory before the clock starts: each step copies its batch up and no
    loader thread runs;
  * `loader_16`, `loader_4`: the production `Places365Loader` live
    (compact feed, prefetch 2), at the long run's 16 threads and at 4.
They run in the order device, host, loader_16, loader_4, then back, so
each is read twice. Then `alone_16`: the 16-thread loader with no step.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

BATCH = 64
PER_CLASS = 1024
WARMUP = 3  # untimed steps before the first case
LOG_EVERY = 50  # Trainer.train's default
ORDER = ["device", "host", "loader_16", "loader_4",
         "loader_4", "loader_16", "host", "device"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--per_class", type=int, default=PER_CLASS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the width factors 8 (a CPU rehearsal)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

    import dataclasses

    import torch

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data import native
    from semantic_pyramid_for_image_generation_torch.scripts import (
        loader_scaling_bench as bench,
    )
    from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
        make_jpeg_tree,
    )
    from semantic_pyramid_for_image_generation_torch.train.loop import (
        Trainer,
        step_generator,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        card_line,
        resolve_device,
    )

    device = resolve_device(args.device)
    config = PyramidGANConfig().tiny() if args.tiny else PyramidGANConfig()
    config = dataclasses.replace(config, compute_dtype="bfloat16")

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        make_jpeg_tree(root, config.image_size, per_class=args.per_class,
                       classes=args.classes)
        tree_s = time.perf_counter() - start

        def loader(workers: int):
            return bench.make_loader(root, config, BATCH, workers,
                                     compact=True)

        host = list(loader(16))
        trainer = Trainer(config, None, device=device, seed=0,
                          save_data_path=f"{root}/run", allow_random_fid=True)
        on_card = batch_to_device(host[0], device)

        def train_step(batch):
            """Trainer.train_step, which takes a batch on the host; the
            same step on a batch already on the card."""
            if batch is not on_card:
                return trainer.train_step(batch)
            rng = step_generator(trainer.seed + 1, trainer.state.step, device)
            trainer.state, metrics = trainer.step_fn(trainer.state, batch,
                                                     rng)
            return metrics

        for _ in range(WARMUP):
            train_step(on_card)
        sync()

        def batches(case: str):
            if case == "device":
                return [on_card] * len(host)
            if case == "host":
                return host
            return loader(int(case.split("_")[1]))

        def epoch(case: str) -> dict:
            pending, steps, wait = [], 0, 0.0
            cpu = time.thread_time()
            start = time.perf_counter()
            source = iter(batches(case))
            while True:
                t0 = time.perf_counter()
                batch = next(source, None)
                wait += time.perf_counter() - t0
                if batch is None:
                    break
                pending.append((train_step(batch), 0, 0))
                steps += 1
                if len(pending) >= LOG_EVERY:
                    trainer._flush_metrics(pending)
            trainer._flush_metrics(pending)
            sync()
            wall = time.perf_counter() - start
            return {"case": case, "steps": steps,
                    "img_per_s": steps * BATCH / wall,
                    "ms_per_step": 1e3 * wall / steps,
                    "wait_ms_per_step": 1e3 * wait / steps,
                    "main_cpu_ms_per_step":
                        1e3 * (time.thread_time() - cpu) / steps}

        rows = []
        for case in ORDER:
            rows.append(epoch(case))
            print(json.dumps(rows[-1]), flush=True)
        start, n = time.perf_counter(), 0
        for b in loader(16):
            n += b["images"].shape[0]
        alone = n / (time.perf_counter() - start)

    result = {"feed_split": rows, "alone_16_img_per_s": alone,
              "tree_s": tree_s, "images": args.classes * args.per_class,
              "mask_route": "native" if native.native_available() else
              "numpy", "card": card_line() if device.type == "cuda" else
              "cpu",
              "torch": torch.__version__}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
