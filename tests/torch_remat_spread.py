#!/usr/bin/env python3
"""Repeats `chip_smoke.py` phase 11 (c) on one seed in one process and
prints each repeat's `uv`, `bn` and `generator_off` readings of the witness
(the default step again) and of each remat mode against the default step:
the run-to-run spread of a hold whose two sides are fp32 steps that are not
bitwise on the card.

    python tests/torch_remat_spread.py [--seed 0] [--repeats 4]

Needs one card (the full-width fp32 state at the hold's batch of 8);
imports torch, numpy and the port only, through chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from semantic_pyramid_for_image_generation_torch.utils.device import (  # noqa: E402
    card_line,
)

READINGS = ("uv", "bn", "generator_off")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=chip_smoke.SEED)
    p.add_argument("--repeats", type=int, default=4)
    args = p.parse_args()
    device = torch.device("cuda")
    state, initial = chip_smoke.fp32_hold_state(device, args.seed)
    # as check_perf_mode_holds draws them, then the hold's steps
    batches = chip_smoke.pinned_batches(
        state.generator.config, chip_smoke.PM_FP32_BATCH,
        chip_smoke.PM_FUSED_STEPS, args.seed)[:chip_smoke.PM_HOLD_STEPS]
    for i in range(args.repeats):
        readings = chip_smoke.remat_readings(state, initial, batches)
        print(json.dumps({"repeat": i, "seed": args.seed, "readings": {
            name: {k: r[k] for k in READINGS}
            for name, r in readings.items()
            if not name.startswith("recompute")}}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
