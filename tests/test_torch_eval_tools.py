"""The port's reference-API helpers and the FID rehearsal's parts against the
JAX package's, on the same inputs.

Tolerances:
  * mask draws (`get_masks_for_*`) and `render_mask_sweep`'s order: bitwise;
  * `fid_from_activations`: relative 1e-9 (both are float64 numpy and scipy
    on the same arrays; only the BLAS call order can differ);
  * the tensor resizes, fp32: 1e-5 absolute (`tests/test_ops.py`'s bar
    against torch);
  * `StepTimer`: exact, on a fake clock that both timers read;
  * the rehearsal's moments (sum, sum of outer products of the Inception
    activations of real and fake images) at tiny width, fp32: relative 1e-3
    of each array's largest entry, the bar `tests/test_torch_fid.py` holds
    per-batch moments to (summation order over ~90 convolutions; the JAX
    side sums at HIGHEST precision, the port without TF32), with the
    generate's weights carried by utils/pt_interop.py and the latents
    pinned.
"""

import ast
import dataclasses
import importlib
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu import config as jax_config
from semantic_pyramid_for_image_generation_tpu.data import masks as jax_masks
from semantic_pyramid_for_image_generation_tpu.eval import fid as jax_fid
from semantic_pyramid_for_image_generation_tpu.eval import grid as jax_grid
from semantic_pyramid_for_image_generation_tpu.ops import resize as jax_resize
from semantic_pyramid_for_image_generation_tpu.utils import (
    profiling as jax_profiling,
)
from semantic_pyramid_for_image_generation_torch import config
from semantic_pyramid_for_image_generation_torch.data import masks
from semantic_pyramid_for_image_generation_torch.eval import fid, grid
from semantic_pyramid_for_image_generation_torch.ops import resize
from semantic_pyramid_for_image_generation_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = "semantic_pyramid_for_image_generation_tpu"
PORT = "semantic_pyramid_for_image_generation_torch"
SUBPACKAGES = ("data", "eval", "ops", "train", "models")
# JAX's GSPMD placement helpers: no port counterpart, not faked
GSPMD = {"batch_sharding", "replicated_sharding", "shard_batch"}
SCHEDULES = {"default": (masks._DEFAULT, jax_masks._DEFAULT),
             "tiny": (masks.MaskSchedule(config.PyramidGANConfig().tiny()),
                      jax_masks.MaskSchedule(
                          jax_config.PyramidGANConfig().tiny()))}


def _equal_lists(got, want):
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_config_defaults_match_jax():
    for name in ("DEFAULT_BATCH_SIZE", "DEFAULT_LR", "DEFAULT_W_REC",
                 "DEFAULT_W_DIV", "DEFAULT_FID_VAL_IMAGES"):
        assert getattr(config, name) == getattr(jax_config, name), name


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_for_training_match_jax(schedule, seed):
    port, ref = SCHEDULES[schedule]
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):  # several draws from one stream
        _equal_lists(masks.get_masks_for_training(r1, port),
                     jax_masks.get_masks_for_training(r2, ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_for_validation_match_jax(seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        _equal_lists(masks.get_masks_for_validation(r1),
                     jax_masks.get_masks_for_validation(r2))


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("level", range(7))
def test_masks_for_inference_match_jax(level, batch):
    got = masks.get_masks_for_inference(level, batch=batch)
    _equal_lists(got, jax_masks.get_masks_for_inference(level, batch=batch))
    if batch is not None:
        assert all(m.shape[0] == batch and m.flags.writeable for m in got)


def test_masks_default_generator():
    """Without a generator each call draws fresh masks of the contract's
    shapes, as the JAX package's do."""
    got = masks.get_masks_for_training()
    assert [m.shape for m in got] == \
        [m.shape for m in jax_masks.get_masks_for_training()]


def test_fid_from_activations_matches_jax():
    rng = np.random.default_rng(0)
    real = rng.standard_normal((64, 32))
    fake = 0.8 * rng.standard_normal((64, 32)) + 0.3
    want = jax_fid.fid_from_activations(real, fake)
    got = fid.fid_from_activations(real, fake)
    assert isinstance(got, float) and want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_fid_from_activations_separates_distributions():
    """tests/test_fid.py's ordering case, in both packages."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((400, 8))
    b = rng.standard_normal((400, 8)) + 2.0
    apart, same = fid.fid_from_activations(a, b), fid.fid_from_activations(a, a)
    assert apart > same
    assert abs(same) < 1e-6
    np.testing.assert_allclose(
        [apart, same], [jax_fid.fid_from_activations(a, b),
                        jax_fid.fid_from_activations(a, a)],
        rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("images,levels", [(7, 7), (3, 5)])
def test_render_mask_sweep_order_matches_jax(images, levels):
    def cell(i, level):  # a 2x2 cell that names its (image, level)
        return np.full((2, 2, 3), 10 * i + level, np.float32)

    got = grid.render_mask_sweep(cell, images, levels)
    want = jax_grid.render_mask_sweep(cell, images, levels)
    assert got.shape == (images * levels, 2, 2, 3)
    np.testing.assert_array_equal(got, want)
    # row = image, column = level
    assert got[levels + 2, 0, 0, 0] == 10 + 2


def _nhwc(seed, h, w, b=2, c=3):
    return np.random.default_rng(seed).standard_normal(
        (b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("shape,out", [((7, 5), (13, 9)), ((8, 8), (16, 16)),
                                       ((16, 12), (5, 7)), ((1, 4), (3, 8))])
def test_resize_bilinear_align_corners_matches_jax(shape, out):
    x = _nhwc(sum(shape), *shape)
    want = np.asarray(jax_resize.resize_bilinear_align_corners(
        jnp.asarray(x), *out))
    got = resize.resize_bilinear_align_corners(torch.from_numpy(x), *out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out", [((8, 8), (16, 16)), ((8, 8), (32, 8)),
                                       ((7, 5), (3, 11)), ((16, 16), (4, 4))])
def test_interpolate_nearest_matches_jax(shape, out):
    x = _nhwc(sum(out), *shape)
    want = np.asarray(jax_resize.interpolate_nearest(jnp.asarray(x), *out))
    got = resize.interpolate_nearest(torch.from_numpy(x), *out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(  # the host variant of the mask pipeline
        got[0, :, :, 0].numpy(), resize.interpolate_nearest_np(x[0, :, :, 0],
                                                               *out))


def test_step_timer_matches_jax(monkeypatch):
    """Both timers on one fake clock: block k lasts k + 1 s; the first
    `warmup` blocks are left out of `times` and `mean`."""
    clock = {"now": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["now"])
    timers = [profiling.StepTimer(warmup=2), jax_profiling.StepTimer(warmup=2)]
    for timer in timers:
        assert timer.mean == 0.0 and timer.times == []
        for k in range(6):
            with timer as entered:
                assert entered is timer
                clock["now"] += k + 1
    port, ref = timers
    assert port.times == ref.times == [3.0, 4.0, 5.0, 6.0]
    assert port.mean == ref.mean == 4.5


def _exports(subpackage: str) -> set:
    """The names a JAX package subpackage's __init__.py imports."""
    tree = ast.parse((REPO / JAX_PACKAGE / subpackage / "__init__.py")
                     .read_text())
    return {alias.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_subpackage_exports_match_jax(subpackage):
    names = _exports(subpackage) - GSPMD
    assert names
    module = importlib.import_module(f"{PORT}.{subpackage}")
    missing = sorted(n for n in names if not hasattr(module, n))
    assert not missing, f"{PORT}.{subpackage} lacks {missing}"


def test_serving_and_parallel_names_exist_in_their_modules():
    """serving/__init__.py imports nothing (the program reader must not
    import the model code) and parallel/__init__.py re-exports nothing, so
    the JAX names are looked for in their modules; JAX's GSPMD helpers and
    `fsdp_spec` (a jax PartitionSpec; the port's counterpart is
    `fsdp_dim`, the sharded dim of a state-dict tensor) have none."""
    found = {}
    for sub, modules in (("serving", ("export", "program")),
                         ("parallel", ("mesh",))):
        for name in modules:
            module = importlib.import_module(f"{PORT}.{sub}.{name}")
            found.setdefault(sub, set()).update(dir(module))
    assert _exports("serving") <= found["serving"]
    assert _exports("parallel") - GSPMD - {"fsdp_spec"} <= found["parallel"]
    assert "fsdp_dim" in found["parallel"]


# ------------------------------------------------------ the FID rehearsal --

REHEARSAL_IMAGES = 8
REHEARSAL_BATCH = 4


@pytest.fixture(scope="module")
def rehearsal():
    """The rehearsal's parts at tiny width in fp32, and the JAX package's
    counterparts on the same weights (the port's seeded init carried into
    JAX variables by utils/pt_interop.py; the Inception of
    tests/torch_inception.py::randomized_mirror, whose activations are
    O(1), in both)."""
    from semantic_pyramid_for_image_generation_tpu.models.inception import (
        convert_inception_state_dict,
    )
    from semantic_pyramid_for_image_generation_tpu.train.state import (
        TrainState,
        make_models as jax_make_models,
    )
    from semantic_pyramid_for_image_generation_tpu.train.step import (
        make_generate_fn as jax_make_generate_fn,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.scripts import (
        fid_rehearsal,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_generate_fn,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        generator_flax_from_state_dict,
        vgg16_flax_from_state_dict,
    )
    from torch_inception import randomized_mirror

    cpu = torch.device("cpu")
    cfg = config.PyramidGANConfig().tiny()
    generator, vgg = make_models(cfg, cpu,
                                 rng=torch.Generator(cpu).manual_seed(0))
    g_vars = generator_flax_from_state_dict(generator.state_dict())
    state = TrainState(
        step=0, g_params=g_vars["params"], g_spectral=g_vars["spectral"],
        g_batch_stats=g_vars["batch_stats"], g_opt_state=None, d_params=None,
        d_spectral=None, d_opt_state=None,
        vgg_params=vgg16_flax_from_state_dict(vgg.state_dict()))
    jax_g, _, jax_vgg = jax_make_models(
        dataclasses.replace(jax_config.PyramidGANConfig().tiny()), True)
    inception_sd = randomized_mirror(seed=0).state_dict()
    staged = fid_rehearsal.stage_batches(
        cfg, REHEARSAL_BATCH, 2, cpu, np.random.default_rng(0))
    noise = np.random.default_rng(7).standard_normal(
        (REHEARSAL_IMAGES // REHEARSAL_BATCH, REHEARSAL_BATCH,
         cfg.latent_dim)).astype(np.float32)
    return dict(
        module=fid_rehearsal, cfg=cfg, staged=staged, noise=noise,
        port=(make_generate_fn(generator, vgg),
              fid.FIDEvaluator(inception_sd, cpu)),
        jax=(state, jax_make_generate_fn(jax_g, jax_vgg),
             jax_fid.FIDEvaluator(convert_inception_state_dict(inception_sd))))


def test_rehearsal_moments_match_jax(rehearsal):
    r = rehearsal
    n_batches = REHEARSAL_IMAGES // REHEARSAL_BATCH
    n, got = r["module"].moments_pass(
        *r["port"], r["staged"], n_batches,
        lambda i: torch.from_numpy(r["noise"][i]))
    assert n == REHEARSAL_IMAGES

    state, generate, evaluator = r["jax"]
    want = None
    for i in range(n_batches):
        batch = {k: (tuple(jnp.asarray(m.numpy()) for m in v)
                     if k == "masks" else jnp.asarray(v.numpy()))
                 for k, v in r["staged"][i % len(r["staged"])].items()}
        fakes = generate(state, batch["images"], batch["masks"],
                         batch["labels"], jax.random.key(0),
                         noise=jnp.asarray(r["noise"][i]))
        new = (*evaluator._moments(evaluator.variables, batch["images"],
                                   REHEARSAL_BATCH),
               *evaluator._moments(evaluator.variables, fakes,
                                   REHEARSAL_BATCH))
        new = [np.asarray(m, np.float64) for m in new]
        want = new if want is None else [a + b for a, b in zip(want, new)]
    for name, g, w in zip(("real sum", "real outer", "fake sum", "fake outer"),
                          got, want):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 1e-3, name  # O(1) activations: not a vacuous hold
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
    # the fakes' moments are not the reals' (G ran)
    assert np.abs(want[0] - want[2]).max() > 1e-2 * np.abs(want[0]).max()


def test_rehearsal_statistics_match_jax(rehearsal):
    """host_statistics (float64, scipy sqrtm) and device_statistics (float32
    eigh) against the JAX package's reductions of the same moments, of 16-dim
    activations (a 2048-dim sqrtm costs ~20 s on one core and computes
    nothing else): the host ones relative 1e-9, the device ones relative
    1e-3 (tests/test_fid.py's bar for the float32 reduction)."""
    module = rehearsal["module"]
    rng = np.random.default_rng(3)
    real = rng.standard_normal((40, 16))
    fake = 0.7 * rng.standard_normal((40, 16)) + 0.2
    totals = tuple(torch.from_numpy(a).float() for a in
                   (real.sum(0), real.T @ real, fake.sum(0), fake.T @ fake))
    fid_host, host_s = module.host_statistics(40, totals)
    fid_device, device_s = module.device_statistics(40, totals)
    moments = [t.double().numpy() for t in totals]
    want = jax_fid.fid_from_statistics(
        *jax_fid.statistics_from_moments(40, *moments[:2]),
        *jax_fid.statistics_from_moments(40, *moments[2:]))
    want_device = float(jax_fid.fid_from_moments_device(
        40, *(jnp.asarray(m, jnp.float32) for m in moments)))
    assert want > 1.0 and host_s > 0 and device_s > 0
    np.testing.assert_allclose(fid_host, want, rtol=1e-9)
    np.testing.assert_allclose(fid_device, want_device, rtol=1e-3)
    np.testing.assert_allclose(fid_device, want, rtol=1e-3)


def test_rehearsal_stages_the_jax_scripts_batches(rehearsal):
    """`stage_batches` draws what the JAX script's staging loop draws from
    np.random.default_rng(0): data/synthetic.py's validation batches."""
    from semantic_pyramid_for_image_generation_tpu.data.synthetic import (
        synthetic_batch as jax_synthetic_batch,
    )

    rng = np.random.default_rng(0)
    jcfg = jax_config.PyramidGANConfig().tiny()
    for staged in rehearsal["staged"]:
        want = jax_synthetic_batch(jcfg, REHEARSAL_BATCH, rng, validation=True)
        for key in ("images", "labels"):
            np.testing.assert_array_equal(staged[key].numpy(), want[key])
        _equal_lists([m.numpy() for m in staged["masks"]], want["masks"])


def test_rehearsal_latents_and_card_check(rehearsal):
    """latent_stream draws batch after batch from one seeded generator;
    main() without a card and without --device cpu raises before it builds
    anything."""
    module, cfg = rehearsal["module"], rehearsal["cfg"]
    cpu = torch.device("cpu")
    a, b = module.latent_stream(cfg, 3, cpu), module.latent_stream(cfg, 3, cpu)
    first, second = a(0), a(1)
    assert first.shape == (3, cfg.latent_dim)
    torch.testing.assert_close(b(0), first, rtol=0, atol=0)
    assert not torch.equal(first, second)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(["--num", "4", "--batch", "2"])
