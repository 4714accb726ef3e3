#!/usr/bin/env python3
"""Reads whether the host or the device sets the pace of BigGAN-deep's
bf16 train step at 64 rows an update (2 D updates, 1 G update, the EMA) on
one card, for the port package found under `--tree` (default: this
checkout), and prints one JSON line.

    python tests/torch_host_pace.py [--tree DIR]

Run a commit and its parent (unpacked with `git archive` into a directory
`.gitignore` lists) in one call on one card: parent, change, change,
parent. Full width, random weights from seed 0, one batch made on the
card before any timing. It reads

  * synced: host ms of each of STEPS steps, each ended by a synchronize;
  * queued: STEPS steps issued back to back, then one synchronize: the
    host ms a step to issue them, the main thread's CPU ms a step, and how
    long the device ran on after the last call returned. A step the device
    paces leaves the launch queue full when the host is done (tens of ms
    of kernels); one the host paces leaves it empty;
  * the device's kernel ms and kernel count a step (torch.profiler, 3
    steps), and the host us a step's issue takes per kernel;
  * the host syncs inside one step (`torch.cuda.set_sync_debug_mode`).

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings

STEPS = 10  # timed, after 3 warm-ups
ROWS = 64  # a D update's real rows, as the benchmark's BigGAN-deep cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    from semantic_pyramid_for_image_generation_torch.config import (
        BigGANDeepConfig,
    )
    from semantic_pyramid_for_image_generation_torch.train import (
        biggan_deep,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        card_line,
    )

    device = torch.device("cuda")
    config = BigGANDeepConfig(compute_dtype="bfloat16")
    state = biggan_deep.init_state(config, device, seed=0)
    g = torch.Generator(device).manual_seed(0)
    rows = ROWS * config.num_d_steps
    size = config.resolution
    batch = {"images": torch.randint(0, 256, (rows, size, size, 3),
                                     dtype=torch.uint8, generator=g,
                                     device=device),
             "labels": torch.randint(0, config.num_classes, (rows,),
                                     generator=g, device=device)}
    step = biggan_deep.make_train_step()
    for _ in range(3):
        step(state, batch, g)
    torch.cuda.synchronize()

    synced = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step(state, batch, g)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)

    t0, cpu0 = time.perf_counter(), time.thread_time()
    for _ in range(STEPS):
        step(state, batch, g)
    issued, cpu = time.perf_counter() - t0, time.thread_time() - cpu0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, batch, g)
        torch.cuda.synchronize()
    kernel_us, kernels = 0.0, 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernel_us += event.time_range.elapsed_us()
            kernels += 1

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(state, batch, g)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    print(json.dumps({
        "tree": os.path.abspath(args.tree), "card": card_line(),
        "synced_ms": {"median": statistics.median(synced),
                      "min": min(synced), "max": max(synced)},
        "queued_issue_ms_per_step": issued * 1e3 / STEPS,
        "queued_host_cpu_ms_per_step": cpu * 1e3 / STEPS,
        "queued_done_ms_per_step": done * 1e3 / STEPS,
        "device_ran_on_ms": (done - issued) * 1e3,
        "device_kernel_ms_per_step": kernel_us / 1e3 / 3,
        "kernels_per_step": kernels / 3,
        "host_us_per_kernel": issued * 1e6 / STEPS / (kernels / 3),
        "syncs_in_a_step": len(caught),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
