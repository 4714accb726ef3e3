"""Data parallelism over processes: the port's counterpart of the data axis
of the JAX package's parallel/mesh.py.

The JAX package shards each global batch over a device mesh, and GSPMD turns
every reduction over the batch into a psum. Here each process (a rank) owns
one device and its rows of the global batch, and those reductions are
written out:
  * in the graph, differentiable, and the identity at world size 1:
    `all_reduce_sum` (the batch-norm sums, models/layers.py) and
    `all_gather_rows` (the labels the projection head pairs with,
    models/discriminator.py; the fakes and latents of the diversity loss,
    train/losses.py). With `remat_blocks` the batch-norm all-reduces of
    G's blocks run again when the backward recomputes the blocks, on every
    rank in the same order, and `collective_bytes` counts the re-runs;
  * explicit: `all_reduce_gradients` between each backward and its
    optimizer step, one flat bucket per network, summed;
    `broadcast_state` from rank 0, once, at construction (as DDP does);
    `sum_over_ranks_` of the step metrics and the FID moments. These run
    whenever a process group exists, a one-rank group included, so a
    one-rank run takes the collective path that N ranks take;
  * `check_replicated`, once the ranks have loaded their files: every rank
    reads the VGG, a checkpoint and the Inception from its own disk, so the
    ranks must see the same files (a shared file system), and a rank that
    holds another state raises instead of training on it.

The convention: a rank's share of each loss is its part of the global mean
(its rows' sum over the global count), so the ranks' losses sum to the
global loss and the gradients are summed, never averaged. Every rank holds
the same number of rows of a train batch: `Places365Loader` shards a global
batch that the CLI rounds to a multiple of the world size. A validation
batch may split unevenly (`global_rows`).

G and D are not wrapped in DistributedDataParallel: a step runs D three
times and G twice, and the G phase's backward takes G's parameters only,
where DDP's reducer expects one forward per backward over all parameters.

No fallback: a failed collective raises, and `init_distributed` gives the
group a timeout, so a missing collective fails instead of hanging.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from semantic_pyramid_for_image_generation_torch.utils.device import (
    resolve_device,
)

TIMEOUT_S = 120  # the process group's collective timeout

# bytes each kind of collective left on this rank since the last reset (the
# reduced or broadcast tensor, or the gathered rows of an all-gather): a
# counter read as the kernels' launch counts are (ops/cuda/__init__.py)
collective_bytes: Dict[str, int] = {}


def reset_collective_bytes() -> None:
    collective_bytes.update(all_reduce=0, all_gather=0, broadcast=0)


reset_collective_bytes()


def init_distributed(device_type: str = "cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    cuda:LOCAL_RANK, or the CPU for `device_type` "cpu". The backend is
    nccl on cuda and gloo on the CPU unless `backend` names one; cuda
    without a card raises."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"init_distributed: {', '.join(missing)} not set; launch with "
            "torchrun --nproc_per_node N ... --multihost")
    if device_type == "cuda":
        device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"init_distributed: device type {device_type!r} is "
                         "neither cuda nor cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **({"device_id": device} if backend == "nccl" else {}))
    return device


def shutdown_distributed() -> None:
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def shard_slice(n: int, world: int, shard: int) -> slice:
    """Shard `shard`'s rows of a global batch of `n`: the contiguous split
    of np.array_split, as Places365Loader shards a batch."""
    base, extra = divmod(n, world)
    start = shard * base + min(shard, extra)
    return slice(start, start + base + (shard < extra))


def global_rows(n_local: int, rows: Optional[Sequence[int]] = None
                ) -> Tuple[int, int, int]:
    """(start, stop, total): this rank's rows in its global batch. `rows` is
    a sharded loader's `shard_rows`; without it every rank holds `n_local`
    rows."""
    if rows is not None:
        start, stop, total = (int(r) for r in rows)
        if stop - start != n_local:
            raise ValueError(f"shard_rows {start}:{stop} for {n_local} rows")
        return start, stop, total
    rows_of = shard_slice(n_local * world_size(), world_size(), rank())
    return rows_of.start, rows_of.stop, n_local * world_size()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` (picklable) on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ------------------------------------------------------------ collectives --


def _all_reduce(t: torch.Tensor) -> None:
    collective_bytes["all_reduce"] += t.numel() * t.element_size()
    dist.all_reduce(t)


def _broadcast(t: torch.Tensor) -> None:
    collective_bytes["broadcast"] += t.numel() * t.element_size()
    dist.broadcast(t, src=0)


def _flat_apply(tensors: Sequence[torch.Tensor],
                op: Callable[[torch.Tensor], None]) -> None:
    """Run `op` on one flat copy of `tensors` per dtype, then copy the
    results back into them."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))


@torch.no_grad()
def sum_over_ranks_(tensors: Iterable[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place."""
    if is_distributed():
        _flat_apply(list(tensors), _all_reduce)


def all_reduce_gradients(module: torch.nn.Module) -> None:
    """Sum every parameter gradient of `module` over the ranks, in place,
    in one flat bucket. A parameter without a gradient has none on any rank
    (every rank builds the same graph)."""
    sum_over_ranks_(p.grad for p in module.parameters() if p.grad is not None)


@torch.no_grad()
def broadcast_state(state) -> None:
    """Rank 0's G and D (parameters, spectral u/v, batch-norm statistics)
    on every rank, one flat bucket per network and dtype. The frozen VGG is
    left out: every rank loads it from the same file or seed."""
    if is_distributed():
        for net in (state.generator, state.discriminator):
            _flat_apply(list(net.state_dict().values()), _broadcast)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's share of the 0-d metrics summed over the ranks: the
    global losses, the same on every rank."""
    if not is_distributed():
        return metrics
    values = torch.stack(list(metrics.values()))
    sum_over_ranks_([values])
    return dict(zip(metrics, values.unbind()))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank. The global loss sums
    the ranks' losses, each a function of y, so the gradient of x is the
    sum over the ranks of the gradients of y: the backward all-reduces
    too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        _all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        _all_reduce(grad)
        return grad


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order. It assumes every rank
    takes the same 1/world share of the same loss of the whole (the
    diversity loss, train/losses.py), so each rank's gradient of the whole
    is 1/world of the true one: the backward returns this rank's rows of it
    times the world size, with no collective."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        world = world_size()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        collective_bytes["all_gather"] += world * x.numel() * x.element_size()
        ctx.rows = shard_slice(world * x.shape[0], world, rank())
        ctx.world = world
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad[ctx.rows] * ctx.world


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable; `x` at world size 1."""
    return x if world_size() == 1 else _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (the same shape on each), concatenated along dim 0
    in rank order; `x` at world size 1. Differentiable for a loss that every
    rank computes alike and takes 1/world of (`_AllGatherRows`)."""
    return x if world_size() == 1 else _AllGatherRows.apply(x)


# ------------------------------------------------------------ replication --


def state_digest(state, vgg: bool = False) -> str:
    """sha256 over G's and D's state dicts (parameters, u/v, running
    statistics), both Adam states (moments, step counts) and the step; with
    `vgg`, the VGG's state dict too."""
    digest = hashlib.sha256()

    def feed(tree) -> None:
        if isinstance(tree, torch.Tensor):
            t = tree.detach().reshape(-1).contiguous().cpu()
            digest.update(str(t.dtype).encode())
            digest.update(t.view(torch.uint8).numpy().tobytes())
        elif isinstance(tree, dict):
            for k in tree:
                digest.update(str(k).encode())
                feed(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                feed(v)
        else:
            digest.update(repr(tree).encode())

    for net in ("generator", "discriminator"):
        feed(getattr(state, net).state_dict())
        feed(getattr(state, f"{net[0]}_optimizer").state_dict())
    feed(int(state.step))
    if vgg:
        feed(state.vgg.state_dict())
    return digest.hexdigest()


def check_replicated(state, **facts: Any) -> None:
    """Raise on every rank unless all ranks hold the same G, D, VGG, Adam
    states and step, and report the same `facts` (which weight files each
    found). Every rank reads its files from its own disk: the ranks of one
    run must see the same files."""
    if not is_distributed():
        return
    mine = {"state": state_digest(state, vgg=True), **facts}
    every = [None] * world_size()
    dist.all_gather_object(every, mine)
    differ = [r for r, theirs in enumerate(every) if theirs != every[0]]
    if differ:
        shown = {r: {k: (v[:12] if k == "state" else v)
                     for k, v in every[r].items()} for r in [0, *differ]}
        raise RuntimeError(
            f"ranks {differ} hold another state than rank 0 after loading "
            f"their files: {shown}; every rank reads --load_pretrained_vgg16, "
            "--load_checkpoint, --auto_resume and --load_inception from its "
            "own disk, so all ranks must see the same files (a shared file "
            "system)")
