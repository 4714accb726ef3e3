"""The readings the limits of `correct` are set from, for one cell on
several seeds in one process (the card's set-up paid once per seed):

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 3]

For each seed: the program's numbers, as a run of the cell computes them.
For each control seed besides: each of the cell's entry's `CONTROLS`, read
by its `control_readings` and held against the float32 reference by its
`gaps` (for a training entry: the reference put in the program's place at
the precision below the configuration's, float8 operands, and the planted
faults in the reference, the losses taken over half of the batch's rows
and a learning rate of 0, which leaves the state unchanged). One JSON line
per seed, with the leaves behind its worst-leaf numbers (of training
readings), then the largest program reading and the smallest control
reading of each number.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from benchmark.run import ROOT, set_cache_dirs  # noqa: E402


def seeds_of(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def training_controls(entry, session) -> tuple:
    """({control: numbers}, {control: readings}) of each of the entry's
    CONTROLS (the float8 control and the planted faults), its readings
    against the session's float32 reference by the entry's `gaps`."""
    reference = session.readings["reference"]
    out, planted = {}, {}
    for name in entry.CONTROLS:
        planted[name] = entry.control_readings(session, name)
        out[name] = entry.gaps(planted[name], reference)
    return out, planted


def worst_leaves(readings: dict, reference: dict, top: int = 3) -> dict:
    """The leaves of the largest gaps of `readings` against the reference,
    over the leaves the gaps count (`common.training_gaps`), with both
    norms and the median: where a worst-leaf number comes from."""
    from benchmark.entries import common

    out = {}
    if "grads" not in reference:  # not training readings
        return out
    for kind in ("grads", "change"):
        rows = []
        for group, ref in reference[kind].items():
            got = readings[kind][group]
            floor = common.CHANGE_LEAF_FLOOR * statistics.median(
                reference["grads"][group].values())
            keys = [k for k, g in reference["grads"][group].items()
                    if g >= floor]
            median = statistics.median(ref[k] for k in keys)
            rows += [(abs(got.get(k, 0.0) - ref[k]) / max(ref[k], median),
                      f"{group}.{k}", got.get(k, 0.0), ref[k], median)
                     for k in keys]
        out[kind] = [[name, gap, g, r, m] for gap, name, g, r, m in
                     sorted(rows, reverse=True)[:top]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    set_cache_dirs()
    import importlib

    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    device = torch.device("cuda", 0)
    controls = set(seeds_of(args.control_seeds))
    worst, least = {}, {}
    for seed in seeds_of(args.seeds) + sorted(controls - set(seeds_of(args.seeds))):
        t0 = time.perf_counter()
        session = entry.Session(cell, seed, device, False, None)
        window = session.window(args.seconds)
        numbers = session.check()
        row = {"seed": seed, "program": numbers,
               "seconds": round(time.perf_counter() - t0, 1)}
        if seed in seeds_of(args.seeds):
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0.0), v)
        readings = session.readings
        row["worst_leaves"] = worst_leaves(readings["program"],
                                           readings["reference"])
        if seed in controls:
            row["controls"], planted = training_controls(entry, session)
            for name, numbers in row["controls"].items():
                row[f"worst_leaves_{name}"] = worst_leaves(
                    planted[name], readings["reference"])
                for k, v in numbers.items():
                    least.setdefault(k, []).append(v)
        row["window"] = {k: v for k, v in window.items()
                         if isinstance(v, (int, float))}
        del session
        harness.free()
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell.name, "program_largest": worst,
                      "controls_smallest": {k: min(v) for k, v in
                                            least.items()},
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
