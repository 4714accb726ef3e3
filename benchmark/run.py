"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell is an entry of `BENCHMARK.json`'s
`workloads`; its configuration, traffic mix and limits are the data files
that name finds (README.md). `--trace 0` times the window and prints the
cell's end-to-end metrics; `--trace 1` runs the same window, then two short
profiled sub-windows, and prints the cell's per-layer metrics. Either way
the outputs of the timed path are held against the plain reference after
the window, and the numbers compared go last, on standard error and in the
line. Exit codes: 0 with a result line; 3 without the card(s) the cell
needs; 4 when JAX or the JAX package was loaded; anything else on an error.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up is timed from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "semantic_pyramid_for_image_generation_tpu")
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout (gitignored)
THREADS = 1  # host threads of torch's CPU ops: one process, few threads


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def set_cache_dirs() -> None:
    """Every kernel cache at a fixed directory of the checkout, so only a
    cell's first run there builds (the program's own library is built into
    its package's `_build/`, also in the checkout)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_cache_dirs()
    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the result's process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
