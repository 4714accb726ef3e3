"""Data parallelism and sharded state over processes: the port's
counterpart of the JAX package's parallel/mesh.py, its data axis and (the
FSDP section below, `--fsdp`) its fsdp axis.

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
import math
import os
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Sequence, Tuple)

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
    collective_bytes.update(all_reduce=0, all_gather=0, broadcast=0,
                            fsdp_all_gather=0, fsdp_reduce_scatter=0)


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
    """Sum every whole parameter gradient of `module` over the ranks, in
    place, in one flat bucket. A parameter without a gradient has none on
    any rank (every rank builds the same graph). The gradients of sharded
    leaves (`shard_state`) are left alone: FSDP has summed them."""
    sum_over_ranks_(p.grad for p in module.parameters()
                    if p.grad is not None and not is_dtensor(p.grad))


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


def _feed(digest, tree) -> None:
    if isinstance(tree, torch.Tensor):
        t = full_tensor(tree.detach()).reshape(-1).contiguous().cpu()
        digest.update(str(t.dtype).encode())
        digest.update(t.view(torch.uint8).numpy().tobytes())
    elif isinstance(tree, dict):
        for k in tree:
            digest.update(str(k).encode())
            _feed(digest, tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _feed(digest, v)
    else:
        digest.update(repr(tree).encode())


def tree_digest(tree) -> str:
    """sha256 over nested tensors (sharded ones whole), dicts, lists and
    scalars."""
    digest = hashlib.sha256()
    _feed(digest, tree)
    return digest.hexdigest()


def state_digest(state, vgg: bool = False) -> str:
    """sha256 over G's and D's state dicts (parameters, u/v, running
    statistics), both Adam states (moments, step counts) and the step; with
    `vgg`, the VGG's state dict too. Sharded tensors are digested whole:
    every rank gathers them, so every rank calls this."""
    tree = []
    for net in ("generator", "discriminator"):
        tree += [getattr(state, net).state_dict(),
                 getattr(state, f"{net[0]}_optimizer").state_dict()]
    tree.append(int(state.step))
    if vgg:
        tree.append(state.vgg.state_dict())
    return tree_digest(tree)


def check_replicated(state=None, **facts: Any) -> None:
    """Raise on every rank unless all ranks hold the same G, D, VGG, Adam
    states and step (unless `state` is None), and report the same `facts`
    (which weight files each found, the digest of a file each read). Every
    rank reads its files from its own disk: the ranks of one run must see
    the same files."""
    if not is_distributed():
        return
    mine = dict(facts)
    if state is not None:
        mine["state"] = state_digest(state, vgg=True)
    every = [None] * world_size()
    dist.all_gather_object(every, mine)
    differ = [r for r, theirs in enumerate(every) if theirs != every[0]]
    if differ:
        shown = {r: {k: (v[:12] if k in ("state", "file") else v)
                     for k, v in every[r].items()} for r in [0, *differ]}
        raise RuntimeError(
            f"ranks {differ} hold another state than rank 0 after loading "
            f"their files: {shown}; every rank reads --load_pretrained_vgg16, "
            "--load_checkpoint, --auto_resume and --load_inception from its "
            "own disk, so all ranks must see the same files (a shared file "
            "system)")


# ------------------------------------------------------------------- FSDP --
#
# Sharded state (`--fsdp K`), the counterpart of the JAX package's (data,
# fsdp) mesh: N ranks form a (N // K, K) DeviceMesh, consecutive ranks in
# one fsdp group as JAX folds consecutive devices. Each leaf that JAX's
# `fsdp_spec` shards lives on its rank as 1/K of itself, on the same logical
# axis, replicated over `data`; its Adam moments follow it. Every other
# leaf and every buffer (u/v, running statistics) stays whole. FSDP2's
# `fully_shard` wraps each unit (`fsdp_units`) and each network's root with
# `reshard_after_forward=True`: a unit's leaves are all-gathered for each
# of its forwards and again for its backward, and freed after (ZeRO-3, as
# JAX gathers per layer). Its gradients are reduce-scattered over `fsdp`
# and all-reduced over `data`, summed; `all_reduce_gradients` sums the
# whole leaves' gradients over every rank. The step computes what the
# unsharded step computes: only where the state lives changes.

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
# the JAX package's rule: smaller leaves stay whole (a collective for a
# vector buys no memory)
FSDP_MIN_LEAF_ELEMENTS = 1 << 16


def check_fsdp(fsdp: int, world: int) -> None:
    """Raise ValueError when `fsdp` > 1 does not divide the `world` ranks
    (fsdp <= 1 shards nothing, as in the JAX package)."""
    if fsdp > 1 and world % fsdp:
        raise ValueError(f"device count {world} not divisible by fsdp={fsdp}")


def make_mesh(fsdp: int, device_type: str = "cuda"):
    """The (data, fsdp) DeviceMesh of shape (N // fsdp, fsdp) over the N
    ranks of the process group. Raises ValueError when `fsdp` does not
    divide N (one process counts as N = 1), as the JAX package's
    `make_mesh` does for its devices."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    check_fsdp(fsdp, world)
    if fsdp < 1:
        raise ValueError(f"fsdp={fsdp}: the fsdp axis needs 1 or more ranks")
    if not is_distributed():
        raise RuntimeError("make_mesh: no process group; launch with "
                           "torchrun ... --multihost")
    return init_device_mesh(device_type, (world // fsdp, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def fsdp_dim(name: str, shape: Sequence[int], fsdp: int) -> Optional[int]:
    """The dim of the G, D or VGG16 tensor at state-dict key `name` (torch
    `shape`) that the JAX package's `fsdp_spec` shards over `fsdp` ranks, or
    None when it stays whole. JAX decides on the flax leaf: one of
    FSDP_MIN_LEAF_ELEMENTS or more elements is sharded on the first of its
    largest axes that `fsdp` divides. The flax leaf's axes come from
    utils/pt_interop.py's layouts (a conv kernel is (kh, kw, in, out) there
    and (out, in, kh, kw) here), so a tie between two axes resolves to the
    axis JAX picks."""
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        flax_axes,
    )

    if fsdp <= 1 or math.prod(shape) < FSDP_MIN_LEAF_ELEMENTS:
        return None
    dims = flax_axes(name, len(shape))
    flax_shape = [shape[d] for d in dims]
    divisible = [a for a, n in enumerate(flax_shape) if n % fsdp == 0]
    if not divisible:
        return None
    return dims[max(divisible, key=lambda a: flax_shape[a])]


def is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether `shard_state` sharded `module` (a network's root)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor gathered whole, a plain tensor (a collective: every
    rank calls it); any other tensor as it is. It gathers with c10d's
    all_gather: `DTensor.full_tensor`'s functional collective crashes over
    gloo on the card."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard

    mesh, whole = t.device_mesh, t.to_local().contiguous()
    for i, placement in reversed(list(enumerate(t.placements))):
        if isinstance(placement, Shard):
            parts = [torch.empty_like(whole) for _ in range(mesh.size(i))]
            dist.all_gather(parts, whole, group=mesh.get_group(i))
            whole = torch.cat(parts, dim=placement.dim)
    return whole


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full` (a whole tensor) placed as the sharded `like` is: this rank's
    part of it on `like`'s mesh, no collective; `full` itself when `like`
    is whole."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import DTensor, Shard

    local = full.to(device=like.device, dtype=like.dtype)
    mesh = like.device_mesh
    coordinate = mesh.get_coordinate()
    for i, placement in enumerate(like.placements):
        if isinstance(placement, Shard):
            local = local.chunk(mesh.size(i), dim=placement.dim)[coordinate[i]]
    return DTensor.from_local(local.contiguous(), mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def load_state_dict_(module: torch.nn.Module,
                     state_dict: Mapping[str, torch.Tensor]) -> None:
    """`module.load_state_dict(state_dict, strict=True)` from whole tensors,
    each placed as the module's own tensor of that key is (`shard_like`)."""
    own = module.state_dict()
    module.load_state_dict({k: shard_like(v, own[k]) if k in own else v
                            for k, v in state_dict.items()}, strict=True)


def fsdp_units(net: torch.nn.Module) -> list:
    """The modules below a network's root that `shard_state` wraps where
    they hold a sharded leaf: G's five and D's seven residual blocks, and
    the VGG's conv and linear layers. The root holds the rest (the
    attention, the linear, final and head layers)."""
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        DiscriminatorInputResidualBlock,
        DiscriminatorResidualBlock,
        GeneratorResidualBlock,
    )

    kinds = (GeneratorResidualBlock, DiscriminatorInputResidualBlock,
             DiscriminatorResidualBlock, torch.nn.Conv2d, torch.nn.Linear)
    return [m for m in net.modules() if m is not net and isinstance(m, kinds)]


def _counted_comms():
    """FSDP2's own all-gather and reduce-scatter, their bytes counted in
    `collective_bytes`: the gathered output, the reduced input."""
    from torch.distributed.fsdp._fully_shard._fsdp_collectives import (
        DefaultAllGather,
        DefaultReduceScatter,
    )

    class Gather(DefaultAllGather):
        def __call__(self, output_tensor, input_tensor, group,
                     async_op=False):
            collective_bytes["fsdp_all_gather"] += (
                output_tensor.numel() * output_tensor.element_size())
            return super().__call__(output_tensor, input_tensor, group,
                                    async_op=async_op)

    class Scatter(DefaultReduceScatter):
        def __call__(self, output_tensor, input_tensor, group, op,
                     async_op=False):
            collective_bytes["fsdp_reduce_scatter"] += (
                input_tensor.numel() * input_tensor.element_size())
            return super().__call__(output_tensor, input_tensor, group, op,
                                    async_op=async_op)

    return Gather(), Scatter()


def sum_gradients_(module) -> None:
    """FSDP2 sums a unit's gradients over the ranks (its default is the
    mean): a divide factor of 1 with plain sums, as gloo has no
    PREMUL_SUM."""
    module.set_gradient_divide_factor(1.0)
    module.set_force_sum_reduction_for_comms(True)


def shard_state(state, mesh):
    """Shard `state` (G, D and the frozen VGG) over `mesh`'s fsdp axis in
    place and return it, with both Adam optimizers rebuilt over the sharded
    parameters (`fully_shard` replaces each module's parameters, so an
    optimizer built before would step tensors that no longer run). Call it
    on every rank, once the ranks hold the same state (after
    `broadcast_state` and the weight files) and before the optimizers hold
    any (a restore or a step): it raises otherwise. The eval-mode cache of
    each sharded spectral layer's normalized weight is turned off (it would
    key on the gathered copy and keep it alive)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from semantic_pyramid_for_image_generation_torch.models.layers import (
        _SpectralNormLayer,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        make_optimizers,
    )

    if state.g_optimizer.state or state.d_optimizer.state:
        raise ValueError("shard_state: the optimizers hold state already; "
                         "shard before restoring a checkpoint or stepping")
    check_replicated(state)
    fsdp = mesh.size(1)
    for net in (state.generator, state.discriminator, state.vgg):
        dims = {p: fsdp_dim(name, p.shape, fsdp)
                for name, p in net.named_parameters()}
        for p, dim in dims.items():
            if dim is not None:  # FSDP2 shards contiguous tensors only
                p.data = p.data.contiguous()
        kwargs = dict(mesh=mesh, reshard_after_forward=True,
                      shard_placement_fn=lambda p, dims=dims: Shard(dims[p]),
                      ignored_params={p for p, d in dims.items() if d is None})
        for m in net.modules():
            if isinstance(m, _SpectralNormLayer) and \
                    dims[m.weight_orig] is not None:
                m.cache_normalized = False
        units = [u for u in fsdp_units(net)
                 if any(dims[p] is not None for p in u.parameters())]
        for unit in units:
            fully_shard(unit, **kwargs)
        fully_shard(net, **kwargs)
        # in the backward each unit prefetches the one before it, so each
        # is gathered once per backward pass through it and never for a
        # forward that has none (FSDP2's default follows the order of every
        # forward since the last backward: the no-grad VGG forward on the
        # real batch too). The root and the first unit prefetch themselves,
        # nothing: an empty list would mean FSDP2's default, and the root's
        # hook fires once per output (the VGG's seven).
        for m, before in zip(units[1:], units):
            m.set_modules_to_backward_prefetch([before])
        for m in [net, *units[:1]]:
            m.set_modules_to_backward_prefetch([m])
        for m in [net, *units]:
            sum_gradients_(m)
            gather, scatter = _counted_comms()
            m.set_custom_all_gather(gather)
            m.set_custom_reduce_scatter(scatter)
    lr = state.g_optimizer.param_groups[0]["lr"]
    state.g_optimizer, state.d_optimizer = make_optimizers(
        state.generator, state.discriminator, lr)
    return state
