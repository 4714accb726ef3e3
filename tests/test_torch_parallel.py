"""Data-parallel training over gloo ranks on the CPU against the JAX
package's step on the concatenated batch (parallel/mesh.py).

The ranks are subprocesses (tests/torch_parallel_rank.py) that import only
the port and write their results to a temporary directory; this process
runs the references while they work. From one initial state (the port's
seeded init, u/v advanced 10 iterations, carried into JAX by its
converters) and the same global batches with pinned `noise_d` / `noise_g`:

  * 2 ranks at global batch 4 and 3 ranks at global batch 6 (where the
    diversity loss pairs rows 0-2 with 3-5, so rank 1's rows pair with both
    other ranks), two fp32 steps at tiny(), held against the JAX
    `make_train_step` on the concatenated batch under
    tests/test_torch_train_step.py's rule: every metric within rtol 2e-3 /
    atol 2e-5; G and D parameters within 1e-2 lr plus one fp32 ulp on all of
    D's elements and all but 0.1% of G's, every element within 4 lr; u/v
    within 1e-4; the running statistics within 3e-4 relative plus 1e-6
    absolute (2e-5 for the final BN's running mean). The JAX step is the
    computation JAX's tests/test_train_step.py shows equal to its 8-device
    mesh.
  * The first step's gradients, summed over the ranks, against the port's
    one-process step on the concatenated batch: relative L2 error over each
    network within 1e-3. The inputs are the same, so only summation order
    separates them: measured 6e-5 for G (its batch norms' backward cancels)
    and 2e-7 for D. Adam divides out most of a gradient's scale, so averaged
    gradients move the parameters almost as summed ones do (they read 0.5
    here).
  * Every rank ends with the same parameters, Adam moments, u/v, running
    statistics, gradients and metrics, bitwise.
  * Four planted faults, each a global reduction made local (batch-norm
    moments, the diversity halves, the projection's rows, gradients
    averaged instead of summed), each fail that hold.
  * The FID of a Trainer over 2 ranks (validation batches of 4 and 3 rows,
    split 2/2 and 2/1) against one rank: the same count, moments within
    1e-5 relative, the FID within 1e-4 relative.
  * `mesh.check_replicated` passes on equal states and raises on both ranks
    when one parameter element of rank 1's G is one ulp off.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    convert_generator_state_dict,
    convert_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.parallel import mesh
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from test_torch_train_step import CFG, CPU, JCFG, LR, METRICS, _run_jax
from torch_parallel_rank import (
    FAULTS,
    WORKER,
    build_state,
    join,
    start,
    step_run,
    tree_equal,
    validate,
)

WORLDS = {2: 4, 3: 6}  # world size -> global batch
STEPS = 2
GRAD_RTOL = 1e-3


def _inputs(global_batch: int, fid: bool) -> dict:
    state = init_train_state(CFG, CPU, lr=LR, seed=0)
    advance_spectral_norm_(state.generator, 10)
    advance_spectral_norm_(state.discriminator, 10)
    rng = np.random.default_rng(global_batch)
    batches = []
    for _ in range(STEPS):
        batch = jax_synthetic_batch(JCFG, global_batch, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal(
                (global_batch, CFG.latent_dim)).astype(np.float32)
        batches.append(batch)
    inputs = {"config": dataclasses.asdict(CFG), "lr": LR,
              "batches": batches}
    for net in ("generator", "discriminator", "vgg"):
        inputs[net] = getattr(state, net).state_dict()
    if fid:
        inputs["fid"] = [jax_synthetic_batch(JCFG, n, rng, validation=True)
                         for n in (4, 3)]
    return inputs


def _one_process(inputs: dict) -> dict:
    state = build_state(inputs, CPU)
    return step_run(state, inputs["batches"], CPU, 1, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 2- and 3-rank runs, compute the references meanwhile, and
    return {world: (ranks' results, JAX, one process)} and the FIDs."""
    work = tmp_path_factory.mktemp("parallel")
    procs, inputs = {}, {}
    for world, batch in WORLDS.items():
        inputs[world] = _inputs(batch, fid=world == 2)
        out = work / f"world{world}"
        out.mkdir()
        torch.save(inputs[world], out / "inputs.pt")
        spec = {"device": "cpu", "inputs": str(out / "inputs.pt"),
                "out": str(out),
                "runs": ["sound", *FAULTS] if world == 2 else ["sound"],
                "replicated": world == 2}
        (out / "spec.json").write_text(json.dumps(spec))
        procs[world] = start(world, [WORKER, str(out / "spec.json")])
    refs = {}
    try:
        for world, ins in inputs.items():
            variables = (convert_generator_state_dict(ins["generator"]),
                         convert_discriminator_state_dict(ins["discriminator"]),
                         convert_vgg16_state_dict(ins["vgg"]))
            refs[world] = (_run_jax(JCFG, variables, ins["batches"]),
                           _one_process(ins))
        fid_one = validate(inputs[2], CPU, str(work / "fid_one"), 1, 0)
    except BaseException:
        for p in (p for ps in procs.values() for p in ps):
            p.kill()
        raise
    results = {}
    for world, ps in procs.items():
        join(ps, timeout=240)
        out = work / f"world{world}"
        results[world] = {
            run: [torch.load(out / f"{run}_rank{r}.pt", weights_only=False)
                  for r in range(world)]
            for run in (["sound", *FAULTS] if world == 2 else ["sound"])}
    fid_ranks = [torch.load(work / "world2" / f"fid_rank{r}.pt",
                            weights_only=False) for r in range(2)]
    results[2]["replicated"] = [
        torch.load(work / "world2" / f"replicated_rank{r}.pt")
        for r in range(2)]
    return results, refs, (fid_one, fid_ranks)


LIMITS = {"metrics": 1.0, "uv": 1e-4, "bn": 1.0,
          "generator_off": 1e-3, "discriminator_off": 0.0,
          "generator_far": 4.0, "discriminator_far": 4.0,
          "generator_grads": GRAD_RTOL, "discriminator_grads": GRAD_RTOL}


def hold(got: dict, jax_ref, one_process: dict) -> dict:
    """The readings of one run (rank 0's results) against the references,
    under the names of `LIMITS`: the worst metric error over its tolerance,
    the largest u/v error, the worst running-statistics error over its
    tolerance, the share of G's and D's parameter elements further than 1%
    of an Adam step, the largest parameter error in lr, and each network's
    relative L2 gradient error."""
    jax_metrics, jax_snapshots = jax_ref
    readings = dict.fromkeys(LIMITS, 0.0)
    for step, want in enumerate(jax_metrics):
        for k in METRICS:
            err = abs(got["metrics"][step][k] - want[k])
            readings["metrics"] = max(readings["metrics"],
                                      err / (2e-5 + 2e-3 * abs(want[k])))
    final = jax_snapshots[-1]
    for net in ("generator", "discriminator"):
        state, want, grads = got[net], final[net], got["grads"][net]
        off = total = 0
        for key, value in state.items():
            err = (value - want[key]).abs() if key in want else None
            if key.endswith(("weight_u", "weight_v")):
                readings["uv"] = max(readings["uv"], float(err.max()))
            elif key.endswith(("running_mean", "running_var")):
                atol = 2e-5 if key == "final_block.1.running_mean" else 1e-6
                readings["bn"] = max(readings["bn"], float(
                    (err / (atol + 3e-4 * want[key].abs())).max()))
            elif key in grads:
                readings[f"{net}_far"] = max(readings[f"{net}_far"],
                                             float(err.max()) / LR)
                off += int((err > 1e-2 * LR + 2.0 ** -22 * want[key].abs()
                            ).sum())
                total += err.numel()
        readings[f"{net}_off"] = off / total
        ref = one_process["grads"][net]
        assert grads.keys() == ref.keys()
        num = sum(float((grads[k] - ref[k]).square().sum()) for k in ref)
        den = sum(float(ref[k].square().sum()) for k in ref)
        readings[f"{net}_grads"] = (num / den) ** 0.5
    return readings


def _holds(readings: dict) -> bool:
    return all(readings[k] <= limit for k, limit in LIMITS.items())


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_ranks_match_jax_on_the_concatenated_batch(runs, world):
    results, refs, _ = runs
    readings = hold(results[world]["sound"][0], *refs[world])
    print(f"world {world}: readings {readings}, limits {LIMITS}")
    assert _holds(readings), readings


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_ranks_end_bitwise_equal(runs, world):
    results, _, _ = runs
    first, *others = results[world]["sound"]
    for other in others:
        for key in first:
            if key != "collective_bytes":
                assert tree_equal(first[key], other[key]), key
    # every rank gathered the labels, the fakes and the latents
    assert first["collective_bytes"]["all_gather"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_hold(runs, fault):
    results, refs, _ = runs
    readings = hold(results[2][fault][0], *refs[2])
    print(f"{fault}: readings {readings}")
    assert not _holds(readings), readings


def test_fid_over_two_ranks_matches_one_rank(runs):
    _, _, (one, ranks) = runs
    assert [r["n"] for r in ranks] == [one["n"]] * 2 == [7, 7]
    assert ranks[0]["fid"] == ranks[1]["fid"]
    for got, want in zip(ranks[0]["moments"], one["moments"]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(ranks[0]["fid"], one["fid"], rtol=1e-4)


def test_check_replicated_raises_on_every_rank_when_states_differ(runs):
    results, _, _ = runs
    for outcome in results[2]["replicated"]:
        assert outcome["equal"] == ""
        assert outcome["rank1_differs"].startswith(
            "ranks [1] hold another state than rank 0")
        assert "shared file system" in outcome["rank1_differs"]


def test_shard_slice_is_array_split():
    for n in range(0, 9):
        for world in (1, 2, 3, 4):
            want = np.array_split(np.arange(n), world)
            for r in range(world):
                np.testing.assert_array_equal(
                    np.arange(n)[mesh.shard_slice(n, world, r)], want[r])


def test_collectives_are_the_identity_without_a_group():
    x = torch.randn(4, 3, requires_grad=True)
    assert not mesh.is_distributed()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather_rows(x) is x
    assert mesh.global_rows(5) == (0, 5, 5)
    assert mesh.global_rows(2, (3, 5, 7)) == (3, 5, 7)
    with pytest.raises(ValueError):
        mesh.global_rows(3, (3, 5, 7))
    metrics = {"a": torch.tensor(1.0)}
    assert mesh.sum_metrics(metrics) is metrics
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_distributed("cpu")
