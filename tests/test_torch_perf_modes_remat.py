"""`remat_blocks` alone and with `remat_vgg`: the port's step against the
JAX package's step with the same flags (`remat_blocks` in the config,
`remat_vgg` in `make_train_step`), at tests/test_torch_perf_modes.py's
bars; the JAX step recomputes through `nn.remat`, the port through
`models/layers.py::remat`.
"""

import pytest

from test_torch_perf_modes import mode_runs
from test_torch_train_step import (
    assert_metrics_match,
    assert_parameters_match,
    assert_spectral_and_batch_stats_match,
)


@pytest.fixture(scope="module", params=["remat_blocks", "remat_both"])
def runs(request):
    return mode_runs(request.param)


def test_remat_metrics_match_jax(runs):
    (jax_metrics, _), (port_metrics, _) = runs
    assert_metrics_match(port_metrics, jax_metrics)


@pytest.mark.parametrize("net,share", [("generator", 1e-3),
                                       ("discriminator", 0.0)])
def test_remat_parameters_match_jax(runs, net, share):
    (_, jax_snapshots), (_, port_snapshots) = runs
    assert_parameters_match(port_snapshots[-1][net], jax_snapshots[-1][net],
                            share)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("step", [0, 1])
def test_remat_spectral_and_batch_stats_match_jax(runs, net, step):
    (_, jax_snapshots), (_, port_snapshots) = runs
    assert_spectral_and_batch_stats_match(port_snapshots[step][net],
                                          jax_snapshots[step][net], step)
