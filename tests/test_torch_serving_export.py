"""The port's serving-artifact writer (serving/export.py::save_artifact,
cli/export_serving.py) against the JAX package's, on the CPU at tiny().

The port's modules (seeded init, u/v advanced 10 power iterations, random
batch-norm statistics) are carried into the JAX package by its own
converters; `weights.npz` of the port must then hold what the JAX
`save_artifact(weights="external")` writes there,
`_flatten_with_paths(serving_weights(state))`, key for key. Tolerances:
parameters, spectral u/v and batch-norm statistics exact (the bridge only
transposes float32 arrays); the eval sigmas within 1e-6 relative (u^T W v in
float32, summed in another order). A port write-then-read generates what the
in-memory modules generate: the weights round-trip exactly, so within 1e-6
absolute (measured: equal).
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.serving.export import (
    _flatten_with_paths,
    serving_weights as jax_serving_weights,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_generator_state_dict,
    convert_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.cli import export_serving
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.models.layers import (
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.serving.export import (
    ServingArtifact,
    config_from_manifest,
    save_artifact,
)
from semantic_pyramid_for_image_generation_torch.serving.server import (
    GenerateService,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_flax_from_state_dict,
    generator_state_dict_from_flax,
)

CFG = PyramidGANConfig().tiny()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def modules():
    g, v = make_models(CFG, CPU, torch.Generator().manual_seed(0))
    advance_spectral_norm_(g, 10)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in g.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.2 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    return g, v


@pytest.fixture(scope="module")
def artifact(modules, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_artifact"))
    manifest = save_artifact(*modules, out, batch_sizes=(2, 1, 2))
    return out, manifest


def test_weights_npz_matches_jax_save_artifact(modules, artifact):
    g, v = modules
    g_vars = convert_generator_state_dict(g.state_dict())
    state = types.SimpleNamespace(
        g_params=g_vars["params"], g_spectral=g_vars["spectral"],
        g_batch_stats=g_vars["batch_stats"],
        vgg_params=convert_vgg16_state_dict(v.state_dict())["params"])
    want = _flatten_with_paths(jax.device_get(jax_serving_weights(state)))
    with np.load(os.path.join(artifact[0], "weights.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    groups = {k.split("/")[0] + "/" + k.split("/")[1] for k in got
              if k.startswith("g/")}
    assert groups == {"g/params", "g/spectral", "g/batch_stats", "g/sigmas"}
    assert any(k.startswith("vgg/features_0/") for k in got)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == w.dtype == np.float32, key
        assert got[key].shape == w.shape, key
        if key.startswith("g/sigmas/"):
            np.testing.assert_allclose(got[key], w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_manifest(artifact):
    out, manifest = artifact
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["format_version"] == 1
    assert manifest["weights"] == "external" and manifest["classifier"]
    assert manifest["batch_buckets"] == [1, 2]
    assert manifest["programs"] == [] and "no .jaxexp" in manifest["notes"]
    assert config_from_manifest(manifest) == CFG
    assert manifest["shapes"]["masks"] == [[None] + list(s)
                                           for s in CFG.mask_shapes]
    assert sorted(os.listdir(out)) == ["manifest.json", "weights.npz"]


def test_write_then_read_generates_what_the_modules_generate(modules,
                                                             artifact):
    read = ServingArtifact(artifact[0], device="cpu")
    live = ServingArtifact.from_modules(*modules, batch_buckets=(1, 2))
    assert read.buckets == live.buckets == [1, 2]
    rng = np.random.default_rng(3)
    images = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    schedule = MaskSchedule(CFG)
    masks = schedule.batch([schedule.inference_masks(4)] * 2)
    labels = np.eye(CFG.num_classes, dtype=np.float32)[[2, 5]]
    noise = rng.standard_normal((2, CFG.latent_dim)).astype(np.float32)
    got = read.generate(images, masks, labels, noise)
    want = live.generate(images, masks, labels, noise)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert read.classify(images[0]) == live.classify(images[0])


def test_bridge_round_trip_is_exact(modules):
    sd = modules[0].state_dict()
    back = generator_state_dict_from_flax(generator_flax_from_state_dict(sd))
    assert back.keys() == sd.keys()
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


def test_export_serving_cli_writes_a_servable_artifact(tmp_path, capsys):
    out = str(tmp_path / "art")
    assert export_serving.main([
        "--out", out, "--batch_sizes", "1,2", "--device", "cpu",
        "--channel_factor", "8", "--vgg_width_factor", "8",
        "--dtype", "float32", "--seed", "4"]) == 0
    captured = capsys.readouterr()
    assert "randomly initialized" in captured.err
    printed = json.loads(captured.out.strip().splitlines()[-1])
    assert printed["batch_buckets"] == [1, 2]
    assert printed["weights"] == "external"
    service = GenerateService(ServingArtifact(out, device="cpu"))
    assert service.config == PyramidGANConfig(channels_factor=8,
                                              vgg_width_factor=8)
    image = np.random.default_rng(0).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    reply = service.generate_arrays(image, level=3, class_id=1,
                                    num_samples=2)
    assert reply["fakes"].shape == (2, 256, 256, 3)
    assert np.isfinite(reply["fakes"]).all()
    with pytest.raises(ValueError, match=".pt"):
        export_serving.main(["--out", out, "--device", "cpu",
                             "--load_checkpoint", str(tmp_path / "orbax_dir")])
