"""The port's Inception backbone and FID against the JAX package's.

Weights: `tests/torch_inception.py::randomized_mirror` (torchvision names,
non-trivial batch-norm statistics, activations O(1)) converted into JAX
variables by the JAX package's `convert_inception_state_dict`, and bridged
back into the port by `inception_state_dict_from_flax`, so both frameworks
run the same weights.

Tolerances (fp32):
  * Inception features at 299 and at the odd 75x75: atol 3e-4 of the mean
    |feature| (at least 1) and rtol 2e-4, the bar tests/test_inception.py
    holds the JAX backbone to against torchvision's (summation order over
    ~90 convolutions).
  * per-batch moments (sum, sum of outer products) of the same images:
    rtol 1e-3 of each array's largest entry (they inherit the features'
    error; the JAX side sums at HIGHEST precision, the port without TF32).
  * normalizers: 1e-6 absolute.
  * FID scalars, host (float64 sqrtm) and device (float32 eigh) reductions:
    rtol 1e-3, atol 1e-3, the bar tests/test_fid.py holds the JAX device
    reduction to against its host one, on well-conditioned covariances
    (256 dims, 400 samples). The evaluator test's covariances come from 7
    samples in 2048 dims, rank 6: tr sqrtm then sums roots of eigenvalues
    that are zero in exact arithmetic, and a rounding perturbation e of one
    becomes sqrt(e) in the trace, so the float32 device reduction is held
    to 5e-3 relative there (0.25% measured); the host reductions of the two
    frameworks, both float64, hold 1e-3.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.eval import fid as jax_fid
from semantic_pyramid_for_image_generation_tpu.models.inception import (
    InceptionV3Features as JaxInception,
    convert_inception_state_dict,
)
from semantic_pyramid_for_image_generation_torch.eval import fid
from semantic_pyramid_for_image_generation_torch.models.inception import (
    InceptionV3Features,
    make_inception,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    inception_state_dict_from_flax,
)
from torch_inception import randomized_mirror

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, the port's state dict) of one randomized mirror."""
    variables = convert_inception_state_dict(randomized_mirror(seed=0)
                                             .state_dict())
    return variables, inception_state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def evaluators(weights):
    variables, sd = weights
    return (fid.FIDEvaluator(sd, CPU),
            jax_fid.FIDEvaluator(variables))


def _features_close(got, want):
    scale = max(float(np.abs(want).mean()), 1.0)
    np.testing.assert_allclose(got, want, atol=3e-4 * scale, rtol=2e-4)


@pytest.mark.parametrize("shape", [(2, 299, 299, 3), (1, 75, 75, 3)])
def test_inception_features_match_jax(weights, shape):
    variables, sd = weights
    images = np.random.default_rng(shape[1]).uniform(
        -1, 1, shape).astype(np.float32)
    want = np.asarray(JaxInception().apply(variables, jnp.asarray(images)))
    model = make_inception(CPU, state_dict=sd)
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (shape[0], 2048) and got.dtype == np.float32
    _features_close(got, want)


def test_torchvision_state_dict_loads_strict():
    mirror = randomized_mirror(seed=2).state_dict()
    assert list(InceptionV3Features().state_dict()) == list(mirror)
    full = dict(mirror)  # a whole inception_v3 also holds these
    full["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    full["fc.weight"] = torch.zeros(1000, 2048)
    full["fc.bias"] = torch.zeros(1000)
    model = make_inception(CPU, state_dict=full)
    for key, value in model.state_dict().items():
        assert torch.equal(value, mirror[key]), key
    assert not any(p.requires_grad for p in model.parameters())


def test_normalizers_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 8, 8, 3)).astype(
        np.float32) * 5 + 2
    x[0] = 0.5  # a constant sample: clamped, not NaN
    for name in ("normalize_m1_1", "normalize_0_1"):
        got = getattr(fid, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jax_fid, name)(jnp.asarray(x)))
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


def test_masked_moments_match_jax(weights, evaluators):
    variables, _ = weights
    port, ref = evaluators
    images = np.random.default_rng(3).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    got = port.moments(torch.from_numpy(images), 3)
    want = ref._moments(variables, jnp.asarray(images), 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
    # rows past num_valid are left out
    acts = port.activations(torch.from_numpy(images))[:3]
    torch.testing.assert_close(got[1], acts.T @ acts, rtol=1e-5, atol=1e-5)


def test_fid_matches_jax(evaluators):
    """Two batches of 4 with fakes pinned in the batch, the second with
    num_valid 3: host and device reductions against JAX's."""
    port, ref = evaluators
    rng = np.random.default_rng(4)
    batches = []
    for n in (4, 3):
        batches.append({
            "images": rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32),
            "fakes": (0.5 * rng.uniform(-1, 1, (4, 64, 64, 3)) + 0.2).astype(
                np.float32),
            "num_valid": n})
    want = ref.fid([{k: (jnp.asarray(v) if k != "num_valid" else v)
                     for k, v in b.items()} for b in batches],
                   lambda b: b["fakes"])
    got = port.fid([{k: (torch.from_numpy(v) if k != "num_valid" else v)
                     for k, v in b.items()} for b in batches],
                   lambda b: b["fakes"])
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    n, totals = port.last_moments
    assert n == 7
    on_device = port.reduce_moments(n, totals, device_statistics=True)
    np.testing.assert_allclose(on_device, want, rtol=5e-3)


def test_device_reduction_matches_jax_and_host():
    """fid_from_moments_device on inception-like non-negative activations,
    as tests/test_fid.py holds JAX's."""
    rng = np.random.default_rng(5)
    dim, n = 256, 400
    real = np.abs(rng.standard_normal((n, dim))) * 0.4
    fake = np.abs(0.8 * rng.standard_normal((n, dim))) * 0.4 + 0.1
    moments = [real.sum(0), real.T @ real, fake.sum(0), fake.T @ fake]
    host = fid.fid_from_statistics(
        *fid.statistics_from_moments(n, *moments[:2]),
        *fid.statistics_from_moments(n, *moments[2:]))
    want_host = jax_fid.fid_from_statistics(
        *jax_fid.statistics_from_moments(n, *moments[:2]),
        *jax_fid.statistics_from_moments(n, *moments[2:]))
    np.testing.assert_allclose(host, want_host, rtol=1e-12)
    f32 = [m.astype(np.float32) for m in moments]
    got = float(fid.fid_from_moments_device(
        n, *(torch.from_numpy(m) for m in f32)))
    want = float(jax_fid.fid_from_moments_device(
        n, *(jnp.asarray(m) for m in f32)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, host, rtol=1e-3, atol=1e-3)


def test_random_init_needs_opt_in():
    with pytest.raises(ValueError, match="allow_random"):
        fid.FIDEvaluator(device=CPU)
    with pytest.warns(UserWarning, match="NOT a standard FID"):
        ev = fid.FIDEvaluator(device=CPU, allow_random=True)
    assert ev.random_init


def test_a_later_larger_batch_is_counted_whole(weights):
    """Batches of 2, then 5: the moments hold every row of both (fp32 sums
    of the same activations, 1e-5 relative)."""
    _, sd = weights
    ev = fid.FIDEvaluator(sd, CPU, device_statistics=True)
    rng = np.random.default_rng(6)
    images = rng.uniform(-1, 1, (7, 48, 48, 3)).astype(np.float32)
    fakes = rng.uniform(-1, 1, (7, 48, 48, 3)).astype(np.float32)
    batches = [{"images": torch.from_numpy(images[a:b]),
                "fakes": torch.from_numpy(fakes[a:b])}
               for a, b in ((0, 2), (2, 7))]
    got = ev.fid(batches, lambda b: b["fakes"])
    n, totals = ev.last_moments
    assert n == 7 and np.isfinite(got)
    for i, x in enumerate((images, fakes)):
        acts = ev.activations(torch.from_numpy(x))
        for g, w in zip(totals[2 * i:2 * i + 2], (acts.sum(0), acts.T @ acts)):
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))
    assert got == ev.reduce_moments(n, totals)


def test_same_distribution_is_near_zero():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ev = fid.FIDEvaluator(device=CPU, allow_random=True)
    images = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (6, 64, 64, 3)).astype(np.float32))
    assert abs(ev.fid([{"images": images}], lambda b: b["images"])) < 1e-2
