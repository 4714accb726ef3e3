"""One rank of a data-parallel (or sharded, `--fsdp`) run of the port's
train step, and the launcher the multi-process tests start ranks with.

    python tests/torch_parallel_rank.py SPEC.json   # RANK, WORLD_SIZE, ...

A rank joins a gloo group (parallel/mesh.py::init_distributed), loads the
initial G, D and VGG state dicts and the global batches from the spec's
`inputs` file (torch.save), and for each run named in the spec builds the
state, broadcasts it from rank 0, and steps its rows of every batch
(np.array_split's contiguous share), with the spec's `step_flags` (the
train step's perf modes; the config's come with the inputs). Run "sound"
is the port as it is; the other runs plant one fault (`FAULTS`): a global
reduction made local. Each
run's metrics per step, the first and the last step's summed gradients, and
the final G and D state dicts and Adam states go to
`<out>/<run>_rank<r>.pt`. With `fid` in the
inputs, the rank also validates a Trainer on its rows of the validation
batches and writes `<out>/fid_rank<r>.pt`. With `replicated` in the spec,
the ranks run `mesh.check_replicated` on equal states, then with rank 1's
G changed by one ulp, and write what each raised to
`<out>/replicated_rank<r>.pt`; with `sharded_init`, a sharded random init
and a sharding of states that differ (`sharded_init_outcomes`). A spec
may give `jobs` in place of `runs`: each with its own `fsdp` (the state
sharded over a (data, fsdp) mesh), checkpoint restore and save, config
fields and step flags (`jobs_of`).

The planted faults, the readings, the row helpers and the table of the
train step's perf modes with their kernel launches here are also the ones
chip_smoke.py holds the ranks and the modes on the card with.
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
# the faults of sharded state (`fsdp` in the spec): FSDP's default mean in
# place of the sum, the unsharded G-phase backward (`inputs=` G's
# parameters, which under FSDP are shards outside the graph), the whole
# leaves' gradients left unsummed, the optimizers left as built before
# `shard_state`
FSDP_FAULTS = ("fsdp_grads_averaged", "inputs_backward", "whole_grads_local",
               "adam_before_sharding")

# the train step's perf modes: mode -> (config fields, make_train_step
# flags). "canonical" is the projection --fused_d implies, without the
# fusion.
CANONICAL = {"compat_projection": False}
PERF_MODES = {
    "default": ({}, {}),
    "canonical": (CANONICAL, {}),
    "fused_d": (CANONICAL, {"fused_discriminator": True}),
    "remat_vgg": ({}, {"remat_vgg": True}),
    "remat_blocks": ({"remat_blocks": True}, {}),
    "remat_both": ({"remat_blocks": True}, {"remat_vgg": True}),
    "fused_d_remat_blocks": ({**CANONICAL, "remat_blocks": True},
                             {"fused_discriminator": True}),
    "all": ({**CANONICAL, "remat_blocks": True},
            {"fused_discriminator": True, "remat_vgg": True}),
}
# kernel launches per bf16 train step in each mode (the wrappers of
# ops/cuda/{attention,resize,pool,batch_norm}.py): the fused D pass drops
# one D attention, its KV pool and that pool's backward; remat_vgg re-runs
# the VGG's 5 pools on the fakes; remat_blocks the 2 upsamples and the 2
# conditional batch norms of each of G's 5 blocks in the G phase (the D
# phase's G forward keeps no graph, so it does not recompute). G's 11
# training-mode batch norms run Kernels 6 and 7 in each of its two forwards
# and Kernels 8 and 9 in its one backward. A float32 step launches no
# batch-norm kernel (`float32_launches`).
BATCH_NORM_KERNELS = ("batch_norm_stats", "batch_norm_apply",
                      "batch_norm_backward_sums", "batch_norm_backward_dx")
PERF_MODE_LAUNCHES = {
    mode: dict(zip(("pooled_kv_attention", "upsample_2x", "max_pool_2x2",
                    "max_pool_2x2_backward", "upsample_2x_backward",
                    *BATCH_NORM_KERNELS), counts))
    for mode, counts in {
        "default": (5, 22, 30, 14, 11, 22, 22, 11, 11),
        "canonical": (5, 22, 30, 14, 11, 22, 22, 11, 11),
        "fused_d": (4, 22, 29, 13, 11, 22, 22, 11, 11),
        "remat_vgg": (5, 22, 35, 14, 11, 22, 22, 11, 11),
        "remat_blocks": (5, 32, 30, 14, 11, 32, 32, 11, 11),
        "remat_both": (5, 32, 35, 14, 11, 32, 32, 11, 11),
        "fused_d_remat_blocks": (4, 32, 29, 13, 11, 32, 32, 11, 11),
        "all": (4, 32, 34, 13, 11, 32, 32, 11, 11),
    }.items()}


def float32_launches(launches: dict) -> dict:
    """`launches` of a bf16 step as a float32 step makes them: its batch
    norms keep the literal order and launch no kernel."""
    return dict(launches, **dict.fromkeys(BATCH_NORM_KERNELS, 0))


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
    """Plant one fault in the port for the duration:
      * a global reduction made local (`FAULTS`);
      * the recompute of `remat_blocks` unguarded: `recompute_unguarded`,
        a plain checkpoint that advances u/v and the running statistics
        again; `recompute_uv_unguarded`, u/v only; `recompute_bn_twice`,
        the running statistics' momentum only;
      * the fused D pass (`fused_discriminator`) wrong: `fused_labels_shifted`
        pairs the fakes with the labels of the next row;
        `fused_uv_advanced` runs one power iteration of D's u/v more before
        the pass;
      * sharded state wrong (`FSDP_FAULTS`; `shard_state` must run inside
        the context);
      * `sn_cached_sharded`: a sharded spectral layer keeps caching its
        eval-mode weight."""
    from torch import nn

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

    def guarding_only(kind):
        class Partial(layers.RecomputeGuard):
            def __init__(self, block):
                super().__init__(block)
                self.stateful = [m for m in self.stateful
                                 if isinstance(m, kind)]
        return Partial

    fused = step.discriminate_fused

    def labels_shifted(d, images, fake, labels):
        b = images.shape[0]
        pred = d(torch.cat([images.to(fake.dtype), fake]),
                 torch.cat([labels, labels.roll(1, 0)]))
        return pred[:b], pred[b:]

    def uv_advanced(d, images, fake, labels):
        with torch.no_grad():
            layers.advance_spectral_norm_(d, 1)
        return fused(d, images, fake, labels)

    shard_state = mesh.shard_state

    def adam_before(state, device_mesh):
        optimizers = state.g_optimizer, state.d_optimizer
        shard_state(state, device_mesh)
        state.g_optimizer, state.d_optimizer = optimizers
        return state

    def sn_cached(state, device_mesh):
        shard_state(state, device_mesh)
        for net in (state.generator, state.discriminator):
            for m in net.modules():
                if isinstance(m, layers._SpectralNormLayer):
                    m.cache_normalized = True
        return state

    def inputs_backward(loss, generator):
        loss.backward(inputs=list(generator.parameters()))

    if fault == "sound":
        yield
        return
    module, name, replacement = {
        "bn_local": (layers, "all_reduce_sum", local),
        "diversity_local": (losses, "all_gather_rows", local),
        "projection_local": (discriminator, "all_gather_rows", local),
        "grads_averaged": (step, "all_reduce_gradients", averaged),
        "recompute_unguarded": (
            layers.RecomputeGuard, "contexts",
            lambda guard: (contextlib.nullcontext(), contextlib.nullcontext())),
        "recompute_uv_unguarded": (layers, "RecomputeGuard",
                                   guarding_only(nn.BatchNorm2d)),
        "recompute_bn_twice": (layers, "RecomputeGuard",
                               guarding_only(layers._SpectralNormLayer)),
        "fused_labels_shifted": (step, "discriminate_fused", labels_shifted),
        "fused_uv_advanced": (step, "discriminate_fused", uv_advanced),
        "fsdp_grads_averaged": (mesh, "sum_gradients_", lambda module: None),
        "inputs_backward": (step, "backward_generator", inputs_backward),
        "whole_grads_local": (step, "all_reduce_gradients",
                              lambda module: None),
        "adam_before_sharding": (mesh, "shard_state", adam_before),
        "sn_cached_sharded": (mesh, "shard_state", sn_cached),
    }[fault]
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def to_cpu(tree):
    """Nested tensors as CPU copies, sharded ones gathered whole (a
    collective: every rank calls this)."""
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        full_tensor,
    )

    if isinstance(tree, torch.Tensor):
        return full_tensor(tree.detach()).cpu().clone()
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
    """A run's readings against a reference run (state dicts under
    "generator" and "discriminator", the metrics per step, and the first
    step's gradients under "grads" where both runs have them): the worst
    relative metric error; per network, the share of parameter elements
    further than 1% of an Adam step plus one fp32 ulp and (with "grads")
    the relative L2 error of the first step's gradients; the relative L2
    error of the projection embedding's first gradient (`embedding_grads`);
    the largest |difference| of a u/v element (`uv`, unit vectors); the
    largest |difference| of a running statistic over that tensor's largest
    |value| (`bn`)."""
    def rel(a: dict, b: dict) -> float:  # a gradient `a` lacks reads 0
        num = sum(float((a.get(k, torch.zeros_like(b[k])) - b[k]).float()
                        .square().sum()) for k in b)
        den = sum(float(b[k].float().square().sum()) for k in b)
        return (num / den) ** 0.5

    grads = "grads" in got and "grads" in ref
    readings = {"metrics": max(
        abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
        for g, w in zip(got["metrics"], ref["metrics"]) for k in w),
        "uv": 0.0, "bn": 0.0}
    for net in ("generator", "discriminator"):
        off = total = 0
        for key, want in ref[net].items():
            err = (got[net][key] - want).abs()
            if key.endswith(("weight_u", "weight_v")):
                readings["uv"] = max(readings["uv"], float(err.max()))
            elif key.endswith(("running_mean", "running_var")):
                readings["bn"] = max(readings["bn"], float(err.max()) / max(
                    float(want.abs().max()), 1e-30))
            elif want.is_floating_point():
                off += int((err > 1e-2 * lr + 2.0 ** -22 * want.abs()).sum())
                total += err.numel()
        readings[f"{net}_off"] = off / total
        if grads:
            readings[f"{net}_grads"] = rel(got["grads"][net],
                                           ref["grads"][net])
    if grads:
        readings["embedding_grads"] = rel(
            {EMBEDDING: got["grads"]["discriminator"][EMBEDDING]},
            {EMBEDDING: ref["grads"]["discriminator"][EMBEDDING]})
    return readings


def step_collective_bytes(state, rows: int, world: int, fsdp: int = 1,
                          fused_discriminator: bool = False) -> dict:
    """The bytes one rank all-reduces and all-gathers in one train step of
    `rows` rows per rank (`mesh.collective_bytes`), from the config and
    the networks' sizes (`state` may hold `meta` networks):
      * all-reduced: every G and D gradient (fp32) of a whole leaf (with
        `fsdp` 1, all of them), once; each batch norm's per-channel sums
        and squares and the count, (2C + 1) fp32, in the D phase's G
        forward, the G phase's forward and its backward, and once more for
        the batch norms inside G's residual blocks when `remat_blocks`
        recomputes them; the five metrics;
      * all-gathered: the fakes (compute dtype) and the latents (fp32) of
        the diversity loss over the global batch; with the (B, B, 128)
        projection, the labels (int64) in each of D's three passes. The
        canonical projection (`--fused_d`) gathers no labels;
      * with `fsdp` > 1 (`mesh.shard_state`), FSDP's collectives of the
        sharded leaves (fp32, whole sizes: the gathered output, the
        reduced input): each unit (`mesh.fsdp_units`) is all-gathered once
        per forward and once per backward pass through it: G's 3 times
        (the D phase's no-grad forward, the G phase's forward and
        backward), the VGG's 3 (the real batch, the fakes and their
        backward), D's 2 per D-phase pass (2 passes, 1 with
        `fused_discriminator`) and 2 in the G phase. A network's root takes
        no gradient for its inputs, so FSDP reshards it only when the
        backward ends: D's root is gathered once for the D phase's two
        passes. G's and D's gradients are reduce-scattered once each. The
        recomputes of `remat_blocks` and `remat_vgg` run inside the
        backward's gather."""
    from torch import nn

    from semantic_pyramid_for_image_generation_torch.models.layers import (
        GeneratorResidualBlock,
    )
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        fsdp_dim,
        fsdp_units,
    )

    g, d = state.generator, state.discriminator
    config = g.config

    def bn_sums(module):
        return sum(4 * (2 * m.num_features + 1) for m in module.modules()
                   if isinstance(m, nn.BatchNorm2d))

    def sharded(net, sharded: bool, root_only: bool = False) -> int:
        in_units = {p for u in fsdp_units(net) for p in u.parameters()}
        return 4 * sum(p.numel() for name, p in net.named_parameters()
                       if (fsdp_dim(name, p.shape, fsdp) is not None)
                       == sharded and not (root_only and p in in_units))

    reduced = sharded(g, False) + sharded(d, False) + 3 * bn_sums(g) + 4 * 5
    if config.remat_blocks:
        reduced += sum(bn_sums(b) for b in g.main_path
                       if isinstance(b, GeneratorResidualBlock))
    total = world * rows
    fake = config.out_channels * config.image_size ** 2 * (
        2 if config.compute_dtype == "bfloat16" else 4)
    gathered = total * (fake + 4 * config.latent_dim)
    if config.compat_projection:
        gathered += 3 * total * 8
    out = {"all_reduce": reduced, "all_gather": gathered, "broadcast": 0,
           "fsdp_all_gather": 0, "fsdp_reduce_scatter": 0}
    if fsdp > 1:
        d_passes = 1 if fused_discriminator else 2
        d_root = sharded(d, True, root_only=True)
        out["fsdp_all_gather"] = (
            3 * sharded(g, True) + 3 * sharded(state.vgg, True)
            + (2 * d_passes + 2) * (sharded(d, True) - d_root)
            + (d_passes + 3) * d_root)
        out["fsdp_reduce_scatter"] = sharded(g, True) + sharded(d, True)
    return out


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


def step_run(state, batches, device, world: int, rank: int,
             **step_flags) -> dict:
    """Step this rank's rows of each global batch with `make_train_step(
    **step_flags)`: the metrics per step and the first step's gradients
    (their inputs are the same on every rank and in one process, so only
    summation order separates them)."""
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    step = make_train_step(**step_flags)
    out = {"metrics": []}
    for batch in batches:
        state, m = step(state, batch_to_device(
            local_batch(batch, world, rank), device))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out.setdefault("grads", gradients(state))
    return out


def validate(inputs: dict, device: torch.device, workdir: str,
             world: int, rank: int, fsdp: int = 1) -> dict:
    """A Trainer's FID over this rank's rows of the validation batches,
    each batch carrying its `shard_rows` (and `num_valid` 0 for a padded
    row) as a sharded loader's does (data/places365.py::shard_of)."""
    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        shard_of,
    )
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer

    val = []
    for batch in inputs["fid"]:
        n = batch["images"].shape[0]
        rows, valid = shard_of(n, world, rank)
        local = rows_of(batch, rows)
        local["shard_rows"] = np.array([rows[0], rows[-1] + 1, n])
        if not valid:
            local["num_valid"] = np.int64(0)
        val.append(local)
    state = build_state(inputs, device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        trainer = Trainer(state.generator.config, [], val, lr=inputs["lr"],
                          device=device, save_data_path=workdir, state=state,
                          allow_random_fid=True, fid_device_stats=True,
                          write_grids=False, fsdp=fsdp)
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


def generate(state, batch: dict, device: torch.device) -> torch.Tensor:
    """Eval-mode fakes of a numpy batch (its `noise` pinned), on the CPU;
    G back in training mode after."""
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_generate_fn,
    )

    b = batch_to_device(batch, device)
    state.generator.eval()
    try:
        return make_generate_fn(state.generator, state.vgg)(
            b["images"], b["masks"], b["labels"], b["noise"]).cpu()
    finally:
        state.generator.train()


def placements(state) -> dict:
    """(global shape, local shape, sharded dim or None) on this rank of
    each G, D and VGG parameter (`<net>.<key>`) and of each Adam moment
    (`<net>.<key>.exp_avg`, `.exp_avg_sq`)."""
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        is_dtensor,
    )

    def placed(t):
        dims = [q.dim for q in t.placements if q.is_shard()] \
            if is_dtensor(t) else [None]
        local = t.to_local() if is_dtensor(t) else t
        return tuple(t.shape), tuple(local.shape), dims[0]

    out = {}
    for net in ("generator", "discriminator", "vgg"):
        optimizer = getattr(state, f"{net[0]}_optimizer", None)
        for name, p in getattr(state, net).named_parameters():
            out[f"{net}.{name}"] = placed(p)
            slot = optimizer.state.get(p, {}) if optimizer else {}
            for moment in ("exp_avg", "exp_avg_sq"):
                if moment in slot:
                    out[f"{net}.{name}.{moment}"] = placed(slot[moment])
    return out


def sharded_init_outcomes(inputs: dict, device: torch.device,
                          device_mesh) -> dict:
    """`init_train_state(..., mesh=)` on this rank: the digest of the
    sharded random init from seed 0, gathered whole; then what
    `shard_state` raises when rank 1's VGG is one ulp off rank 0's (a rank
    that loaded another weight file) ('' for nothing)."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )

    config = PyramidGANConfig(**inputs["config"])
    state = init_train_state(config, device, lr=inputs["lr"], seed=0,
                             mesh=device_mesh)
    out = {"digest": mesh.state_digest(state, vgg=True), "vgg_differs": ""}
    state = init_train_state(config, device, lr=inputs["lr"], seed=0)
    if mesh.rank() == 1:
        with torch.no_grad():
            p = next(state.vgg.parameters())
            first = (0,) * p.dim()
            p[first] = torch.nextafter(p[first], p[first] + 1)
    try:
        mesh.shard_state(state, device_mesh)
    except RuntimeError as e:
        out["vgg_differs"] = str(e)
    return out


def jobs_of(spec: dict) -> list:
    """The spec's runs as jobs: each its own `jobs` entry, or one per name
    in `runs` with the spec's `fsdp` and `step_flags`. A job: `name` (its
    output file), `run` (a fault of `planted`, default "sound"), `fsdp`,
    `step_flags`, `config` (fields set on G's and D's config), `foreach`
    (Adam's multi-tensor path, the card's default, on or off), `batches`
    (indices into the inputs' batches, default all), `restore` (a
    checkpoint restored before the steps) and `save` (a directory rank 0
    writes the checkpoint after the steps to)."""
    if "jobs" in spec:
        return [dict({"run": "sound"}, **job) for job in spec["jobs"]]
    return [{"name": run, "run": run, "fsdp": spec.get("fsdp", 1),
             "step_flags": spec.get("step_flags", {})}
            for run in spec["runs"]]


def run_job(job: dict, inputs: dict, device: torch.device, meshes: dict
            ) -> dict:
    """One job (`jobs_of`) from the inputs' initial state: its steps'
    metrics, gradients and collective bytes, its final state (snapshot,
    bytes, placements) and, with `generate` in the inputs, its fakes before
    and after the steps."""
    import dataclasses

    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        state_bytes,
    )

    fsdp = job.get("fsdp", 1)
    if fsdp > 1 and fsdp not in meshes:
        meshes[fsdp] = mesh.make_mesh(fsdp, device.type)
    state = build_state(inputs, device)
    for net in (state.generator, state.discriminator):
        net.config = dataclasses.replace(net.config, **job.get("config", {}))
    mesh.broadcast_state(state)
    batches = [inputs["batches"][i]
               for i in job.get("batches", range(len(inputs["batches"])))]
    with planted(job["run"]):
        if fsdp > 1:
            mesh.shard_state(state, meshes[fsdp])
        for optimizer in (state.g_optimizer, state.d_optimizer):
            for group in optimizer.param_groups:  # the card's default
                group["foreach"] = job.get("foreach", group["foreach"])
        if job.get("restore"):
            restore_checkpoint(job["restore"], state)
        result = {"fakes_before": generate(state, inputs["generate"], device)
                  } if "generate" in inputs else {}
        mesh.reset_collective_bytes()
        result.update(step_run(state, batches, device, mesh.world_size(),
                               mesh.rank(), **job.get("step_flags", {})))
        result["collective_bytes"] = dict(mesh.collective_bytes)
        if "generate" in inputs:
            result["fakes"] = generate(state, inputs["generate"], device)
    if job.get("save"):
        save_checkpoint(job["save"], state, step=0, write=mesh.rank() == 0)
        mesh.barrier()
    result.update(snapshot(state), last_grads=gradients(state),
                  state_bytes=state_bytes(state), placements=placements(state))
    return result


def main(spec_path: str) -> int:
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    device = mesh.init_distributed(spec["device"], backend="gloo")
    world, rank = mesh.world_size(), mesh.rank()
    inputs = torch.load(spec["inputs"], weights_only=False)
    out = Path(spec["out"])
    meshes: dict = {}
    for job in jobs_of(spec):
        torch.save(run_job(job, inputs, device, meshes),
                   out / f"{job['name']}_rank{rank}.pt")
    if spec.get("replicated"):
        torch.save(check_replicated_outcomes(inputs, device),
                   out / f"replicated_rank{rank}.pt")
    if spec.get("sharded_init"):
        if 2 not in meshes:
            meshes[2] = mesh.make_mesh(2, device.type)
        torch.save(sharded_init_outcomes(inputs, device, meshes[2]),
                   out / f"sharded_init_rank{rank}.pt")
    if "fid" in inputs:
        torch.save(validate(inputs, device, str(out / "fid_run"), world, rank,
                            spec.get("fsdp", 1)), out / f"fid_rank{rank}.pt")
    mesh.shutdown_distributed()
    print(f"rank {rank} of {world} done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
