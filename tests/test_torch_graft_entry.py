"""The port's driver entry points (semantic_pyramid_for_image_generation_
torch/graft_entry.py) against the repository's root __graft_entry__.py.

Held, on the CPU:
  * `entry_for` at the tiny config against the JAX Generator's
    `apply(..., train=False)` on the port's seeded weights (u/v advanced 10
    power iterations, so the output is not saturated) carried across by
    the JAX package's bridge (`convert_generator_state_dict`), on the
    example arguments and on random ones: fp32, max |difference| <= 5e-6
    (the whole-generate tolerance of the port's generate tests);
    `torch.export` traces `fn` and the program gives fn's output bitwise;
  * `entry()` at full width: only the example arguments' shapes against the
    root entry point's (the forward is not run here);
  * `dryrun_multichip(4, device="cpu")`: its OK line with mesh {data: 2,
    fsdp: 2} and grid side 1808, and its step metrics against one process
    stepping a Trainer on the concatenated batch: within 1e-4 relative (the
    data-parallel holds' limit for metrics, tests/test_torch_parallel.py);
    an odd world gives the (n, 1) mesh;
  * `--device cuda` raises before anything is built when there is no card.
The JAX dry run itself is not run here: it compiles a train step, a
scan-packed FID walk and the grid for a 4-device mesh, ~3 min on this
host; the mesh and grid side it prints are its own constants, held by
`test_mesh_and_grid_follow_the_jax_entry`.
"""

import importlib.util
import re
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.models import (
    Generator as JaxGenerator,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_generator_state_dict,
)
from semantic_pyramid_for_image_generation_torch import graft_entry
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOLERANCE = 5e-6
METRICS_RTOL = 1e-4


def _load_jax_entry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_graft_entry"] = module
    spec.loader.exec_module(module)
    return module


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).numpy()


def _random_args(config, batch: int, seed: int = 3) -> tuple:
    """Random latents, features, binary masks and one-hot labels in the
    port's layout."""
    rng = np.random.default_rng(seed)

    def level(shape, masks):
        a = (rng.integers(0, 2, (batch,) + shape) if masks
             else rng.standard_normal((batch,) + shape)).astype(np.float32)
        t = torch.from_numpy(a)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    return (torch.from_numpy(rng.standard_normal(
                (batch, config.latent_dim)).astype(np.float32)),
            tuple(level(s, False) for s in config.feature_shapes),
            tuple(level(s, True) for s in config.mask_shapes),
            torch.from_numpy(np.eye(config.num_classes, dtype=np.float32)[
                rng.integers(0, config.num_classes, batch)]))


@pytest.fixture(scope="module")
def tiny_entry():
    """The tiny entry with u/v advanced 10 power iterations: from the
    random u/v of an init, sigma is far below the spectral norm and every
    output pixel saturates the tanh, which would hold nothing."""
    fn, args = graft_entry.entry_for(PyramidGANConfig().tiny(), CPU, batch=2)
    with torch.no_grad():
        advance_spectral_norm_(fn.generator, 10)
    return fn, args


@pytest.mark.parametrize("inputs", ["example", "random"])
def test_entry_matches_the_jax_generator(tiny_entry, inputs):
    fn, example = tiny_entry
    config = fn.generator.config
    args = example if inputs == "example" else _random_args(config, 2)
    got = fn(*args).permute(0, 2, 3, 1).numpy()
    variables = convert_generator_state_dict(fn.generator.state_dict())
    latent, features, masks, labels = args
    want = np.asarray(JaxGenerator(JaxConfig().tiny()).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(latent.numpy()),
        [jnp.asarray(_nhwc(f)) for f in features],
        [jnp.asarray(_nhwc(m)) for m in masks], jnp.asarray(labels.numpy()),
        train=False))
    assert got.shape == want.shape == (2, 256, 256, 3)
    assert np.isfinite(got).all()
    assert (np.abs(got) > 0.999).mean() < 0.01  # not saturated
    assert np.abs(got - want).max() <= TOLERANCE


def test_entry_runs_under_torch_export(tiny_entry):
    fn, _ = tiny_entry
    args = _random_args(fn.generator.config, 2, seed=4)
    program = torch.export.export(fn, args, strict=False)
    assert torch.equal(program.module()(*args), fn(*args))


def test_entry_example_arguments_match_the_root_entry_at_full_width():
    """The shapes of `entry()`'s arguments, the root entry's in the port's
    layout, beside the full-width Generator (not run)."""
    config = PyramidGANConfig()
    fn, (latent, features, masks, labels) = graft_entry.entry_for(config, CPU)
    b = graft_entry.ENTRY_BATCH
    assert b == 4 and latent.shape == (b, config.latent_dim)
    assert [tuple(_nhwc_shape(f)) for f in features] == [
        (b,) + s for s in JaxConfig().feature_shapes]
    assert [tuple(_nhwc_shape(m)) for m in masks] == [
        (b,) + s for s in JaxConfig().mask_shapes]
    assert labels.shape == (b, config.num_classes)
    assert not fn.generator.training and fn.generator.config == config
    assert config.compute_dtype == "float32"
    assert sum(p.numel() for p in fn.parameters()) == 29_967_047


def _nhwc_shape(x: torch.Tensor) -> tuple:
    return (x.shape[0],) + tuple(x.shape[2:]) + (x.shape[1],) \
        if x.dim() == 4 else tuple(x.shape)


def test_mesh_and_grid_follow_the_jax_entry():
    """The JAX dry run's mesh (parallel/mesh.py::make_mesh with fsdp 2 for
    an even count) and grid side, read from its source."""
    source = (REPO / "__graft_entry__.py").read_text()
    assert "fsdp=2 if n_devices % 2 == 0 else 1" in source
    assert "side = 7 * (cfg.image_size + 2) + 2" in source
    assert graft_entry.mesh_shape(4) == {"data": 2, "fsdp": 2}
    assert graft_entry.mesh_shape(3) == {"data": 3, "fsdp": 1}
    assert graft_entry.grid_side(256) == 1808
    jax_entry = _load_jax_entry()
    assert callable(jax_entry.dryrun_multichip)


@pytest.fixture(scope="module")
def dryrun4():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = graft_entry.dryrun_multichip(4, device="cpu")
    return result, out.getvalue()


def test_dryrun_prints_its_ok_line(dryrun4):
    result, printed = dryrun4
    line = printed.strip().splitlines()[-1]
    assert re.match(r"dryrun_multichip\(4\) OK \[mesh \{'data': 2, "
                    r"'fsdp': 2\}\] step metrics: ", line), line
    assert line.endswith("grid 1808x1808")
    assert result["mesh"] == {"data": 2, "fsdp": 2}
    assert result["grid_side"] == 1808 and np.isfinite(result["fid"])
    assert all(v == 0 for v in result["launches"].values())  # the CPU


def test_dryrun_step_equals_one_process_on_the_whole_batch(dryrun4,
                                                           tmp_path):
    result, _ = dryrun4
    config = PyramidGANConfig().tiny()
    train, _ = graft_entry.dryrun_inputs(config, 4)
    assert train["images"].shape[0] == 8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-Inception warning
        trainer = Trainer(config, [train], None, device=CPU,
                          save_data_path=str(tmp_path),
                          allow_random_fid=True, write_grids=False)
    want = {k: float(v) for k, v in trainer.train_step(train).items()}
    assert set(result["metrics"]) == set(want)
    for name, value in want.items():
        assert result["metrics"][name] == pytest.approx(
            value, rel=METRICS_RTOL, abs=1e-7), name


def test_dryrun_odd_world_is_a_data_mesh(capsys):
    result = graft_entry.dryrun_multichip(3, device="cpu")
    assert result["mesh"] == {"data": 3, "fsdp": 1}
    assert "dryrun_multichip(3) OK [mesh {'data': 3, 'fsdp': 1}]" in \
        capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_raises_without_a_card(monkeypatch):
    started = []
    monkeypatch.setattr(graft_entry.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    assert started == []
