"""Sharded state (`--fsdp 2`) over four gloo ranks on the CPU, a (2, 2)
(data, fsdp) mesh: ranks 0 and 1 share one copy of the state's shards,
ranks 2 and 3 the other. Two fp32 steps at tiny() of global batches of 8
with pinned latents (tests/test_torch_fsdp_hold.py's inputs), held as the
two-rank mesh is:

  * against the JAX package's step under its `shard_state` on a (2, 2)
    mesh of four virtual CPU devices and the port's one-process step, under
    tests/test_torch_parallel.py's bars but D's parameters, which are held
    to their noise floor as tests/test_torch_perf_modes_port.py holds them
    (an element further than 1% of an Adam step plus one ulp must have a
    first gradient within 1e-6 of D's largest): on these batches one of
    D's 276,146 elements reads 1.5e-2 lr off the JAX step's, in the `--fsdp
    1` ranks as in the `--fsdp 2` ranks (0.0149 lr in both);
  * against the port's `--fsdp 1` ranks on the same rows: FSDP
    reduce-scatters each sharded gradient over `fsdp` and all-reduces the
    result over `data`, where the data-parallel ranks all-reduce over all
    four, so the sums run in another order. Measured: the metrics within
    3.6e-7 relative, the first step's gradients within 4.6e-7 (G) and
    8.1e-9 (D) relative L2, held to 1e-6; D's parameters within 1e-2 lr
    plus one fp32 ulp on every element, G's on all but 479 of 1,410,916
    (at most 1.49 lr), held to tests/test_torch_train_step.py's rule (all
    but 0.1%, every element within 4 lr): G's elements with a first
    gradient at the noise floor step +-lr either way;
  * the ranks end bitwise equal, every sharded leaf and its moments still
    1/2 of themselves, the bytes per rank and per step as worked out.
"""

import pytest
import torch

from semantic_pyramid_for_image_generation_torch.train.state import (
    sharded_state_bytes,
)
from test_torch_fsdp import _meta_state
from test_torch_fsdp_hold import (
    FSDP,
    STEPS,
    assert_stays_sharded,
    fsdp_inputs,
    launch,
    load,
    readings,
    references,
)
from test_torch_parallel import LIMITS
from test_torch_perf_modes_port import assert_off_only_at_noise_floor
from test_torch_train_step import CFG, METRICS, assert_parameters_match
from torch_parallel_rank import join, step_collective_bytes, tree_equal

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp_hold4")
    inputs = fsdp_inputs(WORLD, fid=False)
    jobs = [{"name": "fsdp2", "fsdp": FSDP}, {"name": "fsdp1", "fsdp": 1}]
    procs = launch(work, WORLD, inputs, jobs)
    try:
        refs = references(inputs, WORLD)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    join(procs, timeout=300)
    return {job["name"]: load(work, job["name"], WORLD) for job in jobs}, refs


def test_four_fsdp_ranks_match_jax_fsdp_step(runs):
    results, (jax_ref, one, _) = runs
    limits = dict(LIMITS, discriminator_off=1.0)  # D: its noise floor, below
    for name in ("fsdp2", "fsdp1"):
        got = results[name][0]
        r = readings(got, jax_ref, one)
        print(f"{name}: readings {r}, limits {limits}")
        assert all(r[k] <= limit for k, limit in limits.items()), r
        assert_off_only_at_noise_floor(got["discriminator"],
                                       jax_ref[1][-1]["discriminator"],
                                       one["grads"]["discriminator"])


def test_four_fsdp_ranks_against_data_parallel_ranks(runs):
    results, _ = runs
    got, want = results["fsdp2"][0], results["fsdp1"][0]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (step, k)
    for net, share in (("generator", 1e-3), ("discriminator", 0.0)):
        a, b = got["grads"][net], want["grads"][net]
        assert a.keys() == b.keys()
        num = sum(float((a[k] - b[k]).square().sum()) for k in b)
        den = sum(float(b[k].square().sum()) for k in b)
        assert (num / den) ** 0.5 <= 1e-6, net
        assert_parameters_match(got[net], want[net], share)


def test_four_ranks_end_equal_and_sharded(runs):
    results, (_, _, jax_bytes) = runs
    first, *others = results["fsdp2"]
    for other in others:
        for key in first:
            if key != "collective_bytes":
                assert tree_equal(first[key], other[key]), key
    per_step = step_collective_bytes(_meta_state(CFG), 2, WORLD, fsdp=FSDP)
    for result in results["fsdp2"]:
        assert_stays_sharded(result)
        assert result["state_bytes"] == jax_bytes == sharded_state_bytes(
            _meta_state(CFG), FSDP)
        assert result["collective_bytes"] == {
            k: STEPS * v for k, v in per_step.items()}
