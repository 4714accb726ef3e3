"""Sharded state (`--fsdp 2`) over two gloo ranks on the CPU, a (1, 2)
(data, fsdp) mesh, against the JAX package's step under its
`shard_state` on the same layout of two virtual CPU devices, at tiny().

The ranks are subprocesses (tests/torch_parallel_rank.py, its `jobs`) that
import only the port. From one initial state (the port's seeded init, u/v
advanced 10 iterations, carried into JAX by its converters) and the same
global batches of 4 with pinned latents, two fp32 steps:

  * held against the JAX FSDP step and the port's one-process step on the
    concatenated batch under tests/test_torch_parallel.py's bars (`hold`,
    `LIMITS`): the metrics, G's and D's parameters, u/v, the running
    statistics, and the first step's summed gradients within 1e-3 relative
    L2 of the one-process step's;
  * against the port's `--fsdp 1` ranks on the same rows: bitwise equal,
    metrics, state dicts, Adam states and gradients (measured: a (1, 2)
    mesh's reduce-scatter adds the two ranks' gradients as the all-reduce
    does, and every forward runs on the same gathered weights);
  * the ranks end bitwise equal; every leaf that the JAX package shards
    is still 1/2 of itself on each rank after the steps, on its
    `fsdp_dim`, with both Adam moments, and every other leaf is whole (as
    the JAX package's test_fsdp_multi_step_stays_sharded checks); a rank's
    bytes of parameters and moments are `sharded_state_bytes` and the JAX
    state's per-device bytes after `shard_state`;
  * the collective bytes per step are `step_collective_bytes(fsdp=2)`'s;
  * four planted faults (tests/torch_parallel_rank.py::FSDP_FAULTS) each
    break the hold: FSDP's default mean of the gradients, the G-phase
    backward with `inputs=` G's parameters, the whole leaves' gradients
    left unsummed, Adam built before sharding;
  * generate after training: the eval-mode fakes after the two steps (and
    before them, with the spectral layers' eval weight computed once)
    equal the `--fsdp 1` ranks' bitwise: a sharded spectral layer must not
    serve a weight from before an update;
  * ragged validation: a Trainer at `--fsdp 2` validates batches of 4 and
    1 rows; rank 1 gets no row of the second, generates a padded row it
    does not count, and the FID equals one rank's (count equal, moments
    within 1e-5 relative, FID within 1e-4) with no hang;
  * `init_train_state(..., mesh=)` gathers back to the unsharded init from
    the same seed, bitwise; `shard_state` raises on both ranks when rank
    1's VGG differs by one ulp (a rank that read another weight file
    would hold its part of another state).
tests/test_torch_fsdp_hold4.py holds four ranks, a (2, 2) mesh.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch,
)
from semantic_pyramid_for_image_generation_tpu.parallel import (
    make_mesh as jax_make_mesh,
    shard_state as jax_shard_state,
)
from semantic_pyramid_for_image_generation_tpu.train import state as jstate
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    convert_generator_state_dict,
    convert_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    fsdp_dim,
    state_digest,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
    sharded_state_bytes,
)
from test_torch_fsdp import _jax_per_device_bytes, _meta_state
from test_torch_parallel import LIMITS, _holds, hold
from test_torch_train_step import CFG, CPU, JCFG, LR, _run_jax
from torch_parallel_rank import (
    FSDP_FAULTS,
    WORKER,
    build_state,
    join,
    start,
    step_collective_bytes,
    step_run,
    tree_equal,
    validate,
)

STEPS = 2
FSDP = 2


def fsdp_inputs(world: int, fid: bool) -> dict:
    """The initial state, two global batches of 2 rows per rank with
    pinned latents, a 2-row batch to generate from, and (with `fid`)
    validation batches of 4 and 1 rows."""
    state = init_train_state(CFG, CPU, lr=LR, seed=0)
    advance_spectral_norm_(state.generator, 10)
    advance_spectral_norm_(state.discriminator, 10)
    rng = np.random.default_rng(10 + world)
    batches = []
    for _ in range(STEPS):
        batch = jax_synthetic_batch(JCFG, 2 * world, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal(
                (2 * world, CFG.latent_dim)).astype(np.float32)
        batches.append(batch)
    generate = jax_synthetic_batch(JCFG, 2, rng, validation=True)
    generate["noise"] = rng.standard_normal(
        (2, CFG.latent_dim)).astype(np.float32)
    inputs = {"config": dataclasses.asdict(CFG), "lr": LR,
              "batches": batches, "generate": generate}
    for net in ("generator", "discriminator", "vgg"):
        inputs[net] = getattr(state, net).state_dict()
    if fid:
        inputs["fid"] = [jax_synthetic_batch(JCFG, n, rng, validation=True)
                         for n in (4, 1)]
    return inputs


def launch(work, world: int, inputs: dict, jobs: list) -> list:
    """Start `world` ranks on `jobs` (tests/torch_parallel_rank.py) at
    FSDP (the FID's Trainer too)."""
    torch.save(inputs, work / "inputs.pt")
    spec = {"device": "cpu", "inputs": str(work / "inputs.pt"),
            "out": str(work), "fsdp": FSDP, "jobs": jobs,
            "sharded_init": world == 2}
    (work / "spec.json").write_text(json.dumps(spec))
    return start(world, [WORKER, str(work / "spec.json")])


def references(inputs: dict, world: int):
    """The JAX FSDP step on `world` virtual devices as a (world // 2, 2)
    mesh, the port's one-process step, and the JAX state's per-device
    bytes after `shard_state`."""
    variables = (convert_generator_state_dict(inputs["generator"]),
                 convert_discriminator_state_dict(inputs["discriminator"]),
                 convert_vgg16_state_dict(inputs["vgg"]))
    mesh = jax_make_mesh(jax.devices()[:world], fsdp=FSDP)
    jax_ref = _run_jax(JCFG, variables, inputs["batches"], mesh=mesh)
    g_tx, d_tx = jstate.make_optimizers(LR)
    state = jstate.init_train_state(
        jax.random.key(0), JCFG, g_tx, d_tx, vgg_variables=variables[2],
        g_variables=variables[0], d_variables=variables[1])
    jax_bytes = _jax_per_device_bytes(jax_shard_state(state, mesh))
    one = step_run(build_state(inputs, CPU), inputs["batches"], CPU, 1, 0)
    return jax_ref, one, jax_bytes


def load(work, name: str, world: int) -> list:
    return [torch.load(work / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def readings(got: dict, jax_ref, one: dict) -> dict:
    """`hold`'s readings, a gradient that a run lacks read as zeros (the
    `inputs=` fault leaves G's sharded leaves without one)."""
    grads = {net: {k: got["grads"][net].get(k, torch.zeros_like(v))
                   for k, v in one["grads"][net].items()}
             for net in one["grads"]}
    return hold(dict(got, grads=grads), jax_ref, one)


def assert_stays_sharded(result: dict) -> None:
    """Every leaf `fsdp_dim` shards is 1/FSDP of itself on this rank, with
    its Adam moments; every other leaf is whole; and there are both."""
    kinds = set()
    for key, (shape, local, dim) in result["placements"].items():
        name = key.split(".", 1)[1].removesuffix(".exp_avg").removesuffix(
            ".exp_avg_sq")
        want = fsdp_dim(name, shape, FSDP)
        assert dim == want, key
        expected = list(shape)
        if want is not None:
            expected[want] //= FSDP
        assert local == tuple(expected), key
        kinds.add(want is None)
    assert kinds == {True, False}
    moments = [k for k in result["placements"] if k.endswith("exp_avg")]
    assert moments and any(result["placements"][k][2] is not None
                           for k in moments)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp_hold")
    inputs = fsdp_inputs(2, fid=True)
    jobs = [{"name": "fsdp2", "fsdp": 2}, {"name": "fsdp1", "fsdp": 1}]
    jobs += [{"name": fault, "run": fault, "fsdp": 2}
             for fault in FSDP_FAULTS]
    procs = launch(work, 2, inputs, jobs)
    try:
        refs = references(inputs, 2)
        fid_one = validate(inputs, CPU, str(work / "fid_one"), 1, 0)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    join(procs, timeout=300)
    results = {job["name"]: load(work, job["name"], 2) for job in jobs}
    results["fid"] = load(work, "fid", 2)
    results["sharded_init"] = load(work, "sharded_init", 2)
    return results, refs, fid_one


def test_fsdp_ranks_match_jax_fsdp_step(runs):
    results, (jax_ref, one, _), _ = runs
    r = readings(results["fsdp2"][0], jax_ref, one)
    print(f"readings {r}, limits {LIMITS}")
    assert _holds(r), r


def test_fsdp_ranks_equal_data_parallel_ranks_bitwise(runs):
    results, _, _ = runs
    (first, second), (dp, _) = results["fsdp2"], results["fsdp1"]
    for key in first:
        if key not in ("collective_bytes", "placements", "state_bytes"):
            assert tree_equal(first[key], second[key]), key
            assert tree_equal(first[key], dp[key]), key


def test_sharded_leaves_stay_sharded_with_their_moments(runs):
    results, (_, _, jax_bytes), _ = runs
    for result in results["fsdp2"]:
        assert_stays_sharded(result)
        assert result["state_bytes"] == jax_bytes == sharded_state_bytes(
            _meta_state(CFG), FSDP)
    assert all(d is None for _, _, d in results["fsdp1"][0][
        "placements"].values())


def test_collective_bytes_per_step(runs):
    results, _, _ = runs
    per_step = step_collective_bytes(_meta_state(CFG), 2, 2, fsdp=FSDP)
    assert per_step["fsdp_all_gather"] > 0
    assert per_step["fsdp_reduce_scatter"] > 0
    for result in results["fsdp2"]:
        assert result["collective_bytes"] == {
            k: STEPS * v for k, v in per_step.items()}


@pytest.mark.parametrize("fault", FSDP_FAULTS)
def test_planted_fault_fails_the_hold(runs, fault):
    results, (jax_ref, one, _), _ = runs
    r = readings(results[fault][0], jax_ref, one)
    print(f"{fault}: readings {r}")
    assert not _holds(r), r


def test_generate_after_training_equals_unsharded(runs):
    results, _, _ = runs
    sharded, unsharded = results["fsdp2"][0], results["fsdp1"][0]
    for key in ("fakes_before", "fakes"):
        assert torch.equal(sharded[key], unsharded[key]), key
    assert not torch.equal(sharded["fakes"], sharded["fakes_before"])


def test_ragged_validation_matches_one_rank(runs):
    results, _, one = runs
    ranks = results["fid"]
    assert [r["n"] for r in ranks] == [one["n"]] * 2 == [5, 5]
    assert ranks[0]["fid"] == ranks[1]["fid"]
    for got, want in zip(ranks[0]["moments"], one["moments"]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(ranks[0]["fid"], one["fid"], rtol=1e-4)


def test_sharded_init_and_states_that_differ(runs):
    results, _, _ = runs
    want = state_digest(init_train_state(CFG, CPU, lr=LR, seed=0), vgg=True)
    for outcome in results["sharded_init"]:
        assert outcome["digest"] == want
        assert outcome["vgg_differs"].startswith(
            "ranks [1] hold another state than rank 0")
