#!/usr/bin/env python3
"""Times the port's eager bf16 train step at batch 64 and its bucket-1
request (fc8 auto class) on one card, for the port package found under
`--tree` (default: this checkout), and prints one JSON line.

    python tests/torch_dispatch_timing.py [--tree DIR]

It puts two trees side by side in one run on one card: a commit and its
parent unpacked with `git archive` into a directory `.gitignore` lists, run
parent, change, change, parent. What it reads is the host time the kernel
wrappers add per launch (the train step launches 82 kernels, a bucket-1
request 23): first alone, as the host microseconds of one
`ops.cuda.pool.max_pool_2x2` call on a (1, 64, 8, 8) bf16 tensor (median
of 7 windows of 2,000 calls, the device idle behind them), then inside
the step and the request. Full width, random weights from seed 0,
synthetic batches made before any timing; step times are host clock
around the step and a `torch.cuda.synchronize()`, request times host clock
around `GenerateService.generate_arrays` (which ends in a device-to-host
copy). Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STEP_BATCH = 64
STEPS = 12  # timed, after 2 warm-ups
REQUESTS = 100  # timed, after 3 warm-ups
WRAPPER_CALLS = 2000  # per window, 7 windows


def spread(times: list) -> dict:
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "n": len(times)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    import semantic_pyramid_for_image_generation_torch as port
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.ops import (
        cuda as kernels,
    )
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        GenerateService,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    if not port.__file__.startswith(tree):
        raise RuntimeError(f"imported {port.__file__}, not the port of {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]

    from semantic_pyramid_for_image_generation_torch.ops.cuda import pool

    x = torch.randn(1, 64, 8, 8, device=device, dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    windows = []
    for _ in range(8):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRAPPER_CALLS):
            pool.max_pool_2x2(x)
        windows.append((time.perf_counter() - t0) / WRAPPER_CALLS * 1e6)
        torch.cuda.synchronize()
    wrapper_us = spread(windows[1:])

    config = PyramidGANConfig(compute_dtype="bfloat16")
    state = init_train_state(config, device, seed=0)
    rng = np.random.default_rng(0)
    batches = [batch_to_device(synthetic_batch(config, STEP_BATCH, rng),
                               device) for _ in range(STEPS + 2)]
    step = make_train_step()
    generator = torch.Generator(device).manual_seed(0)
    times, launches = [], None
    for i, batch in enumerate(batches):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, generator)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
    step_ms = spread(times)

    state.generator.eval()
    state.vgg.eval()
    service = GenerateService(ServingArtifact.from_modules(
        state.generator, state.vgg, (1,)))
    image = np.random.default_rng(0).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    times = []
    for i in range(REQUESTS + 3):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        service.generate_arrays(image, level=0, num_samples=1, seed=i)
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        request_launches = {k: after[k] - before[k] for k in after}
    print(json.dumps({
        "tree": tree, "card": card, "torch": torch.__version__,
        "wrapper_us": wrapper_us, "step_batch": STEP_BATCH,
        "step_ms": step_ms,
        "launches_per_step": launches, "request_ms": spread(times),
        "launches_per_request": request_launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
