"""Driver entry points of the PyTorch port, the counterparts of the
repository's root __graft_entry__.py (which stays the JAX package's):

  * `entry(device=None)` -> (fn, example_args): the eval-mode forward of the
    full-width Generator (PyramidGANConfig(), float32) on the card at batch
    4, random-init from a seeded torch.Generator. `fn` is an nn.Module, so
    `torch.export.export(fn, example_args)` traces it as the serving
    programs are traced; its spectral layers compute sigma from their
    weight and stored u/v at every call (no eval cache), as the JAX
    `apply(..., train=False)` does from its variables, so a traced program
    reads the module's parameters.
  * `dryrun_multichip(n, device="cuda")`: n rank processes over gloo (on the
    card they share it) as the (data, fsdp) mesh of parallel/mesh.py::
    make_mesh, (n/2, 2) for even n and (n, 1) for odd n, and through a real
    Trainer over it: one fused train step on a synthetic batch of 2n rows
    (every metric finite), a validation batch by batch over 3 batches of
    max(n, 7) rows (random-init Inception; the JAX package's scan-packed
    `fid_scan` has no counterpart in the port), and the 49-row 7x7 sweep
    grid, whose PNG must be 7 * (256 + 2) + 2 = 1808 pixels a side; all on
    the tiny config. The call prints rank 0's OK line and returns what
    rank 0 measured, its kernel launches included; a rank that fails makes
    the call raise with its output.

    python -m semantic_pyramid_for_image_generation_torch.graft_entry [N] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    initialize_,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
    resolve_device,
)

ENTRY_BATCH = 4
ENTRY_SEED = 0
DRYRUN_TIMEOUT_S = 300  # the ranks, joined; each group has its own 120 s
GRID_CELLS = 7
_REPO = Path(__file__).resolve().parents[1]


class EvalForward(nn.Module):
    """`generator`'s eval-mode forward, no gradients, float32 without TF32:
    (latent, features, masks, labels) -> (B, 3, 256, 256)."""

    def __init__(self, generator: Generator):
        super().__init__()
        self.generator = generator.eval()
        for module in generator.modules():
            if hasattr(module, "cache_normalized"):
                module.cache_normalized = False

    def forward(self, latent, features, masks, labels):
        with torch.no_grad(), exact_float32():
            return self.generator(latent, features, masks, labels)


def entry_for(config: PyramidGANConfig, device: torch.device,
              batch: int = ENTRY_BATCH, seed: int = ENTRY_SEED
              ) -> Tuple[EvalForward, tuple]:
    """`entry` at any config and device: the Generator random-init from
    `seed`, and the example arguments of the root entry point in the port's
    layout (conv levels (B, C, H, W) channels_last, as the VGG pyramid hands
    them over): a zero latent, zero features of `config.feature_shapes`,
    ones masks of `config.mask_shapes`, zero labels."""
    with torch.device(device):
        generator = Generator(config)
    initialize_(generator, torch.Generator(device).manual_seed(seed))
    generator.to(memory_format=torch.channels_last)

    def level(shape, fill):
        x = torch.full((batch,) + tuple(shape), fill, device=device)
        if x.dim() == 4:  # NHWC per-sample shape -> the NCHW view
            x = x.permute(0, 3, 1, 2)
        return x

    args = (torch.zeros((batch, config.latent_dim), device=device),
            tuple(level(s, 0.0) for s in config.feature_shapes),
            tuple(level(s, 1.0) for s in config.mask_shapes),
            torch.zeros((batch, config.num_classes), device=device))
    return EvalForward(generator), args


def entry(device: Optional[str | torch.device] = None
          ) -> Tuple[EvalForward, tuple]:
    """(fn, example_args) of the full-width float32 Generator on `device`
    (default: the card; raises without one)."""
    return entry_for(PyramidGANConfig(), resolve_device(device or "cuda"))


def grid_side(image_size: int, cells: int = GRID_CELLS) -> int:
    """Pixels a side of the sweep grid's PNG (eval/grid.py: 2 px padding)."""
    return cells * (image_size + 2) + 2


def mesh_shape(n: int) -> Dict[str, int]:
    """The (data, fsdp) mesh of n ranks: fsdp 2 when n is even."""
    fsdp = 2 if n % 2 == 0 else 1
    return {"data": n // fsdp, "fsdp": fsdp}


def dryrun_inputs(config: PyramidGANConfig, n: int) -> Tuple[dict, list]:
    """The global train batch of 2n rows and the 3 validation batches of
    max(n, 7) rows, from numpy seed 0 as the root entry point draws them."""
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )

    host = np.random.default_rng(0)
    train = synthetic_batch(config, 2 * n, host)
    val = [synthetic_batch(config, max(n, 7), host, validation=True)
           for _ in range(3)]
    return train, val


def _rows(batch: dict, rows) -> dict:
    out = {k: v[rows] for k, v in batch.items() if k != "masks"}
    out["masks"] = tuple(m[rows] for m in batch["masks"])
    return out


def _dryrun_rank(workdir: str, device_type: str) -> None:
    """One rank (RANK, WORLD_SIZE, MASTER_* set as torchrun sets them):
    rank 0 prints the OK line and writes `workdir/result.json`."""
    from PIL import Image

    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        shard_of,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer

    device = mesh.init_distributed(device_type, backend="gloo")
    try:
        n, rank = mesh.world_size(), mesh.rank()
        shape = mesh_shape(n)
        config = PyramidGANConfig().tiny()  # the 256x256 contract, narrow
        train, val = dryrun_inputs(config, n)
        train = _rows(train, mesh.shard_slice(2 * n, n, rank))
        local_val = []
        for batch in val:
            rows, valid = shard_of(batch["images"].shape[0], n, rank)
            local = _rows(batch, rows)
            local["shard_rows"] = np.array([rows[0], rows[-1] + 1,
                                            batch["images"].shape[0]])
            if not valid:
                local["num_valid"] = np.int64(0)
            local_val.append(local)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-Inception warning
            trainer = Trainer(config, [train], local_val, device=device,
                              save_data_path=os.path.join(workdir, "saved"),
                              allow_random_fid=True, fid_device_stats=True,
                              fsdp=shape["fsdp"])
        # 1. one fused G/D train step over the mesh
        metrics = {k: float(v) for k, v in trainer.train_step(train).items()}
        for name, value in metrics.items():
            if not np.isfinite(value):
                raise FloatingPointError(f"{name} = {value}")
        # 2. the validation, batch by batch (random-init Inception)
        fid = trainer.validate()
        if not np.isfinite(fid):
            raise FloatingPointError(f"FID {fid}")
        # 3. the 7x7 sweep grid: one 49-row generate on every rank
        grid_path = trainer.inference()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = kernels.launch_counts()
        mesh.barrier()
        if rank != 0:
            return
        side = grid_side(config.image_size)
        with Image.open(grid_path) as grid:
            if grid.size != (side, side):
                raise AssertionError(f"grid {grid.size}, expected {side}")
        print(f"dryrun_multichip({n}) OK [mesh {shape}] step metrics:",
              {k: round(v, 4) for k, v in metrics.items()},
              f"fid(random backbone)={fid:.2f}, grid {side}x{side}",
              flush=True)
        result = {"n": n, "mesh": shape, "metrics": metrics, "fid": fid,
                  "grid_side": side, "launches": launches,
                  "device": device.type}
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(result, f)
    finally:
        mesh.shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout: float = DRYRUN_TIMEOUT_S) -> Dict:
    """Run the dry run on `n_devices` rank processes; returns rank 0's
    result (mesh, metrics, FID, grid side, kernel launches, seconds)."""
    device = resolve_device(device)  # cuda without a card raises here
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}")
    port = _free_port()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        procs = []
        for rank in range(n_devices):
            env = dict(os.environ, RANK=str(rank),
                       WORLD_SIZE=str(n_devices), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "2"),
                       PYTHONPATH=os.pathsep.join(
                           [str(_REPO)] + [p for p in [os.environ.get(
                               "PYTHONPATH")] if p]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--rank-of", workdir,
                 "--device", device.type],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outputs = _join(procs, timeout)
        print(next(line for line in outputs[0].splitlines()
                   if line.startswith("dryrun_multichip(")), flush=True)
        with open(os.path.join(workdir, "result.json")) as f:
            result = json.load(f)
    result["seconds"] = time.perf_counter() - start
    return result


def _join(procs: list, timeout: float) -> list:
    """The ranks' outputs; kills every rank past `timeout` seconds in all,
    and raises with the output of each rank that failed."""
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"dryrun_multichip: the ranks ran past {timeout} s")
    failed = [f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outputs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("dryrun_multichip failed\n" + "\n".join(failed))
    return outputs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the port's dry run over "
                                     "N rank processes")
    parser.add_argument("n", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank-of", dest="rank_of", default=None,
                        help=argparse.SUPPRESS)  # a rank of a dry run
    args = parser.parse_args(argv)
    if args.rank_of is not None:
        _dryrun_rank(args.rank_of, args.device)
    else:
        dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
