"""Checkpoints and the perf modes under sharded state (`--fsdp 2`), on two
gloo ranks on the CPU at tiny(), in fp32 (tests/torch_parallel_rank.py's
`jobs`, run in order by the same two ranks):

  * a checkpoint written at `--fsdp 2` after one step is the `--fsdp 1`
    ranks' file tensor for tensor (G, D, both Adam states, the step): every
    rank gathers the shards, rank 0 writes the reference layout. The JAX
    package's `load_reference_gan_checkpoint(include_optimizer=True)`
    reads it, key for key, its Adam moments on the right parameters;
  * resuming it at `--fsdp 2` and taking the second step equals the two
    steps uninterrupted, bitwise (metrics, G, D, both Adam states); so does
    resuming it at `--fsdp 1`, and resuming the `--fsdp 1` file at
    `--fsdp 2`;
  * `--fused_d --remat_blocks` at `--fsdp 2` equals the same modes at
    `--fsdp 1`, bitwise over two steps (the recompute runs inside FSDP's
    backward gather and `RecomputeGuard` still replays u/v), with FSDP's
    bytes per step as `step_collective_bytes` works them out for one D
    pass;
  * the card's multi-tensor Adam (`foreach`) steps the sharded state as
    the one-tensor path does (`ShardedAdam`).
Bitwise, because on a (1, 2) mesh the sharded step computes what the
data-parallel step computes (tests/test_torch_fsdp_hold.py).
"""

import dataclasses
import json

import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.utils import (
    pt_interop as jax_pt,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    parameter_keys,
)
from test_torch_checkpoint import EXPORTS
from test_torch_fsdp import _meta_state
from test_torch_fsdp_hold import fsdp_inputs, load
from test_torch_train_step import CFG
from torch_parallel_rank import (
    PERF_MODES,
    WORKER,
    join,
    start,
    step_collective_bytes,
    tree_equal,
)

MODES = "fused_d_remat_blocks"
STATE = ("generator", "discriminator", "generator_optimizer",
         "discriminator_optimizer")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp_checkpoint")
    inputs = fsdp_inputs(2, fid=False)
    inputs.pop("generate")
    files = {k: str(work / k / "checkpoint_000.pt") for k in ("f2", "f1")}
    fields, flags = PERF_MODES[MODES]
    jobs = [
        {"name": "f2_first", "fsdp": 2, "batches": [0],
         "save": str(work / "f2")},
        {"name": "f1_first", "fsdp": 1, "batches": [0],
         "save": str(work / "f1")},
        {"name": "f2_whole", "fsdp": 2},
        {"name": "f2_resumed", "fsdp": 2, "batches": [1],
         "restore": files["f2"]},
        {"name": "f1_from_f2", "fsdp": 1, "batches": [1],
         "restore": files["f2"]},
        {"name": "f2_from_f1", "fsdp": 2, "batches": [1],
         "restore": files["f1"]},
        {"name": "f2_foreach", "fsdp": 2, "foreach": True},
        {"name": "modes_f2", "fsdp": 2, "config": fields, "step_flags": flags},
        {"name": "modes_f1", "fsdp": 1, "config": fields, "step_flags": flags},
    ]
    torch.save(inputs, work / "inputs.pt")
    spec = {"device": "cpu", "inputs": str(work / "inputs.pt"),
            "out": str(work), "jobs": jobs}
    (work / "spec.json").write_text(json.dumps(spec))
    join(start(2, [WORKER, str(work / "spec.json")]), timeout=300)
    results = {job["name"]: load(work, job["name"], 2) for job in jobs}
    return results, {k: torch.load(v, weights_only=False)
                     for k, v in files.items()}, files


def test_fsdp_checkpoint_is_the_unsharded_file(runs):
    results, ckpts, _ = runs
    sharded, unsharded = ckpts["f2"], ckpts["f1"]
    assert sharded.keys() == unsharded.keys() == {*STATE, "step"}
    assert sharded["step"] == unsharded["step"] == 1
    for key in STATE:
        assert tree_equal(sharded[key], unsharded[key]), key
    for t in (v for net in ("generator", "discriminator")
              for v in sharded[net].values()):
        assert type(t) is torch.Tensor and t.device.type == "cpu"
    # the file holds the state the ranks ended the step with
    for key in STATE:
        assert tree_equal(sharded[key], results["f2_first"][0][key]), key


def test_jax_reads_the_fsdp_checkpoint(runs):
    _, ckpts, files = runs
    g_vars, d_vars, g_mom, d_mom = jax_pt.load_reference_gan_checkpoint(
        files["f2"], include_optimizer=True)
    for net, variables, moments in (("generator", g_vars, g_mom),
                                    ("discriminator", d_vars, d_mom)):
        want = ckpts["f2"][net]
        got = EXPORTS[net](variables)
        assert set(parameter_keys(got)) == set(parameter_keys(want))
        for key, value in want.items():
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(got[key], value), key
        assert moments["count"] == 1
        slots = ckpts["f2"][f"{net}_optimizer"]["state"]
        aux = {k: v for k, v in variables.items() if k != "params"}
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            exported = EXPORTS[net]({"params": moments[moment], **aux})
            for i, key in enumerate(parameter_keys(want)):
                assert torch.equal(exported[key], slots[i][slot]), (net, key)


@pytest.mark.parametrize("resumed", ["f2_resumed", "f1_from_f2",
                                     "f2_from_f1"])
def test_resume_equals_the_uninterrupted_run(runs, resumed):
    results, _, _ = runs
    whole, got = results["f2_whole"][0], results[resumed][0]
    assert got["metrics"] == whole["metrics"][1:]
    for key in STATE:
        assert tree_equal(got[key], whole[key]), key
    assert tree_equal(results[resumed][1]["generator"], got["generator"])


def test_perf_modes_under_fsdp_equal_unsharded(runs):
    results, _, _ = runs
    sharded, unsharded = results["modes_f2"][0], results["modes_f1"][0]
    assert sharded["metrics"] == unsharded["metrics"]
    for key in (*STATE, "grads"):
        assert tree_equal(sharded[key], unsharded[key]), key
    # the modes did change the step, and the fused pass gathers D's units
    # once in the D phase
    assert sharded["metrics"] != results["f2_whole"][0]["metrics"]
    fields, flags = PERF_MODES[MODES]
    per_step = step_collective_bytes(
        _meta_state(dataclasses.replace(CFG, **fields)), 2, 2, fsdp=2,
        fused_discriminator=flags["fused_discriminator"])
    assert sharded["collective_bytes"] == {k: 2 * v
                                           for k, v in per_step.items()}


def test_multi_tensor_adam_steps_the_sharded_state(runs):
    """The card's default Adam (`foreach`) cannot take sharded and whole
    parameters in one call; `train/state.py::ShardedAdam` steps them apart:
    the same update as the one-tensor path the CPU takes."""
    results, _, _ = runs
    got, want = results["f2_foreach"][0], results["f2_whole"][0]
    assert got["generator_optimizer"]["param_groups"][0]["foreach"]
    assert got["metrics"] == want["metrics"]
    for key in ("generator", "discriminator"):
        assert tree_equal(got[key], want[key]), key
