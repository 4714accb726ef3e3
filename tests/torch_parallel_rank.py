"""One rank of a data-parallel run of the port's train step, and the
launcher the multi-process tests start ranks with.

    python tests/torch_parallel_rank.py SPEC.json   # RANK, WORLD_SIZE, ...

A rank joins a gloo group (parallel/mesh.py::init_distributed), loads the
initial G, D and VGG state dicts and the global batches from the spec's
`inputs` file (torch.save), and for each run named in the spec builds the
state, broadcasts it from rank 0, and steps its rows of every batch
(np.array_split's contiguous share). Run "sound" is the port as it is; the
other runs plant one fault (`FAULTS`): a global reduction made local. Each
run's metrics per step, the first and the last step's summed gradients, and
the final G and D state dicts and Adam states go to
`<out>/<run>_rank<r>.pt`. With `fid` in the
inputs, the rank also validates a Trainer on its rows of the validation
batches and writes `<out>/fid_rank<r>.pt`. With `replicated` in the spec,
the ranks run `mesh.check_replicated` on equal states, then with rank 1's
G changed by one ulp, and write what each raised to
`<out>/replicated_rank<r>.pt`.

The planted faults, the readings and the row helpers here are also the
ones chip_smoke.py's data-parallel phase holds the ranks on the card with.
Imports torch, numpy and the port only: it runs on a host without JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WORKER = str(Path(__file__).resolve())
FAULTS = ("bn_local", "diversity_local", "projection_local", "grads_averaged")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world: int, argv: list, cwds: list | None = None) -> list:
    """Start `world` processes of `python *argv` (this script: [WORKER,
    spec path]), each told its rank as torchrun tells it; rank r runs in
    `cwds[r]` (default: the repository root)."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env,
            cwd=str(cwds[r]) if cwds else str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def join(procs: list, timeout: float = 240.0) -> list:
    """Wait for every rank until `timeout` seconds in all; on expiry kill
    them all and raise. Raises with the output of every rank that exits
    non-zero. Returns the ranks' outputs."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"ranks did not finish within {timeout} s")
    failed = [f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def rows_of(batch: dict, rows) -> dict:
    """Rows (a slice or an index array) of a numpy batch (masks a tuple)."""
    out = {k: v[rows] for k, v in batch.items() if k != "masks"}
    out["masks"] = tuple(m[rows] for m in batch["masks"])
    return out


def local_batch(batch: dict, world: int, rank: int) -> dict:
    """Rank `rank`'s rows of a numpy global batch."""
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        shard_slice,
    )

    return rows_of(batch, shard_slice(batch["images"].shape[0], world, rank))


@contextlib.contextmanager
def planted(fault: str):
    """Replace one global reduction of the port with its local form."""
    from semantic_pyramid_for_image_generation_torch.models import (
        discriminator,
        layers,
    )
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train import losses, step

    def averaged(module):
        mesh.all_reduce_gradients(module)
        for p in module.parameters():
            if p.grad is not None:
                p.grad.div_(mesh.world_size())

    def local(x):
        return x

    if fault == "sound":
        yield
        return
    module, name, replacement = {
        "bn_local": (layers, "all_reduce_sum", local),
        "diversity_local": (losses, "all_gather_rows", local),
        "projection_local": (discriminator, "all_gather_rows", local),
        "grads_averaged": (step, "all_reduce_gradients", averaged),
    }[fault]
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def gradients(state) -> dict:
    """The gradients G's and D's parameters hold (summed over the ranks
    after a step), on the CPU."""
    return {net: {k: to_cpu(p.grad) for k, p in
                  getattr(state, net).named_parameters() if p.grad is not None}
            for net in ("generator", "discriminator")}


def snapshot(state) -> dict:
    """What a hold reads after a run: G and D state dicts and both Adam
    states, on the CPU."""
    out = {}
    for net in ("generator", "discriminator"):
        out[net] = to_cpu(getattr(state, net).state_dict())
        out[f"{net}_optimizer"] = to_cpu(
            getattr(state, f"{net[0]}_optimizer").state_dict())
    return out


def tree_equal(a, b) -> bool:
    """Bitwise equality of nested tensors, dicts, lists and scalars."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tree_equal, a, b))
    return a == b


EMBEDDING = "embedding.weight_orig"  # the projection head's class embedding


def readings_against(got: dict, ref: dict, lr: float) -> dict:
    """A run's readings against the one-process run on the concatenated
    batch (`step_run` plus `snapshot`): the worst relative metric error;
    per network, the share of parameter elements further than 1% of an Adam
    step plus one fp32 ulp, and the relative L2 error of the first step's
    gradients; the relative L2 error of the projection embedding's first
    gradient (`embedding_grads`)."""
    def rel(a: dict, b: dict) -> float:
        num = sum(float((a[k] - b[k]).float().square().sum()) for k in b)
        den = sum(float(b[k].float().square().sum()) for k in b)
        return (num / den) ** 0.5

    readings = {"metrics": max(
        abs(g[k] - w[k]) / abs(w[k])
        for g, w in zip(got["metrics"], ref["metrics"]) for k in w)}
    for net in ("generator", "discriminator"):
        off = total = 0
        for key in ref["grads"][net]:
            want = ref[net][key]
            err = (got[net][key] - want).abs()
            off += int((err > 1e-2 * lr + 2.0 ** -22 * want.abs()).sum())
            total += err.numel()
        readings[f"{net}_off"] = off / total
        readings[f"{net}_grads"] = rel(got["grads"][net], ref["grads"][net])
    readings["embedding_grads"] = rel(
        {EMBEDDING: got["grads"]["discriminator"][EMBEDDING]},
        {EMBEDDING: ref["grads"]["discriminator"][EMBEDDING]})
    return readings


def build_state(inputs: dict, device: torch.device):
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )

    config = PyramidGANConfig(**inputs["config"])
    state = init_train_state(config, device, lr=inputs["lr"])
    for net in ("generator", "discriminator", "vgg"):
        getattr(state, net).load_state_dict(inputs[net])
    return state


def step_run(state, batches, device, world: int, rank: int) -> dict:
    """Step this rank's rows of each global batch: the metrics per step and
    the first step's gradients (their inputs are the same on every rank
    and in one process, so only summation order separates them)."""
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    step = make_train_step()
    out = {"metrics": []}
    for batch in batches:
        state, m = step(state, batch_to_device(
            local_batch(batch, world, rank), device))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out.setdefault("grads", gradients(state))
    return out


def validate(inputs: dict, device: torch.device, workdir: str,
             world: int, rank: int) -> dict:
    """A Trainer's FID over this rank's rows of the validation batches,
    each batch carrying its `shard_rows` as a sharded loader's does."""
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        shard_slice,
    )
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer

    val = []
    for batch in inputs["fid"]:
        n = batch["images"].shape[0]
        rows = shard_slice(n, world, rank)
        if rows.stop > rows.start:
            local = local_batch(batch, world, rank)
            local["shard_rows"] = np.array([rows.start, rows.stop, n])
            val.append(local)
    state = build_state(inputs, device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        trainer = Trainer(state.generator.config, [], val, lr=inputs["lr"],
                          device=device, save_data_path=workdir, state=state,
                          allow_random_fid=True, fid_device_stats=True,
                          write_grids=False)
    fid = trainer.validate()
    n, totals = trainer.fid_evaluator.last_moments
    return {"fid": fid, "n": n, "moments": [t.cpu() for t in totals]}


def check_replicated_outcomes(inputs: dict, device: torch.device) -> dict:
    """What `mesh.check_replicated` raises on this rank for equal states,
    then with rank 1's first G parameter one ulp off ('' for nothing)."""
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    state = build_state(inputs, device)
    mesh.broadcast_state(state)
    outcomes = {}
    for case in ("equal", "rank1_differs"):
        if case == "rank1_differs" and mesh.rank() == 1:
            with torch.no_grad():
                p = next(state.generator.parameters()).view(-1)
                p[0] = torch.nextafter(p[0], p[0] + 1)
        try:
            mesh.check_replicated(state, vgg_file_found=False)
            outcomes[case] = ""
        except RuntimeError as e:
            outcomes[case] = str(e)
    return outcomes


def main(spec_path: str) -> int:
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    device = mesh.init_distributed(spec["device"], backend="gloo")
    world, rank = mesh.world_size(), mesh.rank()
    inputs = torch.load(spec["inputs"], weights_only=False)
    out = Path(spec["out"])
    for run in spec["runs"]:
        state = build_state(inputs, device)
        mesh.broadcast_state(state)
        mesh.reset_collective_bytes()
        with planted(run):
            result = step_run(state, inputs["batches"], device, world, rank)
        result.update(snapshot(state), last_grads=gradients(state),
                      collective_bytes=dict(mesh.collective_bytes))
        torch.save(result, out / f"{run}_rank{rank}.pt")
    if spec.get("replicated"):
        torch.save(check_replicated_outcomes(inputs, device),
                   out / f"replicated_rank{rank}.pt")
    if "fid" in inputs:
        torch.save(validate(inputs, device, str(out / "fid_run"), world, rank),
                   out / f"fid_rank{rank}.pt")
    mesh.shutdown_distributed()
    print(f"rank {rank} of {world} done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
