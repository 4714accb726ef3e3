"""The port's train-step perf modes against the JAX package's step with the
same flags: `fused_discriminator` (`--fused_d`, on the canonical projection)
and `remat_vgg` here, `remat_blocks` alone and with `remat_vgg` in
tests/test_torch_perf_modes_remat.py (one JAX compile per mode; two files
keep each under two minutes on one worker).

From one state and the same batches with pinned latents (the helpers of
tests/test_torch_train_step.py), two fp32 steps of each side, held to that
file's bars: the metrics within rtol 2e-3 / atol 2e-5; G's post-update
parameters within 1% of an Adam step plus one ulp on all but 0.1% of its
elements, D's on every element; u/v within 1e-4; the running statistics
within 3e-4 relative plus 1e-6 absolute.
"""

import dataclasses

import pytest

from test_torch_train_step import (
    CFG,
    JCFG,
    _batches,
    _run_jax,
    _run_port,
    _variables,
    assert_metrics_match,
    assert_parameters_match,
    assert_spectral_and_batch_stats_match,
)
from torch_parallel_rank import PERF_MODES


def mode_runs(mode: str):
    """((JAX metrics, snapshots), (port metrics, snapshots)) of two fp32
    steps in `mode` (the same config fields and step flags on both sides,
    tests/torch_parallel_rank.py's PERF_MODES)."""
    fields, flags = PERF_MODES[mode]
    cfg = dataclasses.replace(CFG, **fields)
    jcfg = dataclasses.replace(JCFG, **fields)
    variables = _variables(cfg)
    batches = _batches(jcfg, 2)
    return (_run_jax(jcfg, variables, batches, **flags),
            _run_port(cfg, variables, batches, **flags))


@pytest.fixture(scope="module", params=["fused_d", "remat_vgg"])
def runs(request):
    return mode_runs(request.param)


def test_mode_metrics_match_jax(runs):
    (jax_metrics, _), (port_metrics, _) = runs
    assert_metrics_match(port_metrics, jax_metrics)


@pytest.mark.parametrize("net,share", [("generator", 1e-3),
                                       ("discriminator", 0.0)])
def test_mode_parameters_match_jax(runs, net, share):
    (_, jax_snapshots), (_, port_snapshots) = runs
    assert_parameters_match(port_snapshots[-1][net], jax_snapshots[-1][net],
                            share)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("step", [0, 1])
def test_mode_spectral_and_batch_stats_match_jax(runs, net, step):
    (_, jax_snapshots), (_, port_snapshots) = runs
    assert_spectral_and_batch_stats_match(port_snapshots[step][net],
                                          jax_snapshots[step][net], step)
