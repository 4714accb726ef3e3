"""Serving in the port: the JAX artifact reader, the service, the HTTP layer
and the CLIs, on the CPU at tiny widths.

A JAX artifact is written once per module with `save_artifact(weights=
"external", batch_sizes=(1, 2))`, as tests/test_serving_export.py does; the
port's `ServingArtifact` reads its manifest and weights.npz and must give the
JAX service's PNGs to within one level of 255 (the PNG encode min-max-scales
each image, so fp32 rounding differences show up at most as one level).
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.serving import save_artifact
from semantic_pyramid_for_image_generation_tpu.serving.export import (
    ServingArtifact as JaxServingArtifact,
)
from semantic_pyramid_for_image_generation_tpu.serving.server import (
    GenerateService as JaxGenerateService,
)
from semantic_pyramid_for_image_generation_tpu.train.state import (
    init_train_state,
    make_optimizers,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.serving.export import (
    ServingArtifact,
)
from semantic_pyramid_for_image_generation_torch.serving.server import (
    GenerateService,
    make_server,
)
from test_torch_models import realistic_generator_variables

JCFG = JaxConfig(channels_factor=8, vgg_width_factor=8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    g_tx, d_tx = make_optimizers()
    state = init_train_state(jax.random.key(0), JCFG, g_tx, d_tx)
    g_vars = realistic_generator_variables(
        {"params": state.g_params, "spectral": state.g_spectral,
         "batch_stats": state.g_batch_stats})
    as_jnp = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    state = state.replace(g_params=as_jnp(g_vars["params"]),
                          g_spectral=as_jnp(g_vars["spectral"]),
                          g_batch_stats=as_jnp(g_vars["batch_stats"]))
    out = str(tmp_path_factory.mktemp("artifact"))
    save_artifact(state, JCFG, out, batch_sizes=(1, 2), weights="external")
    return out


@pytest.fixture(scope="module")
def port_service(artifact_dir):
    return GenerateService(ServingArtifact(artifact_dir, device="cpu"))


def _png_b64(seed=0, size=256) -> str:
    pixels = (np.random.default_rng(seed).random((size, size, 3)) * 255)
    buf = io.BytesIO()
    Image.fromarray(pixels.astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))),
                      dtype=np.int16)


def test_service_matches_jax_service(artifact_dir, port_service):
    jax_service = JaxGenerateService(JaxServingArtifact(artifact_dir))
    requests = [
        {"image_b64": _png_b64(0), "level": 3, "class_id": 5,
         "num_samples": 1, "seed": 3},
        # class from the fc8 argmax; 2 samples take the 2-bucket
        {"image_b64": _png_b64(1), "level": 5, "num_samples": 2, "seed": 1},
    ]
    for request in requests:
        want = jax_service.generate(request)
        got = port_service.generate(request)
        assert got["bucket"] == want["bucket"]
        assert got["class_id"] == want["class_id"]
        assert len(got["images"]) == len(want["images"]) == request["num_samples"]
        for g, w in zip(got["images"], want["images"]):
            g, w = _decode(g), _decode(w)
            assert g.shape == w.shape == (256, 256, 3)
            assert np.abs(g - w).max() <= 1


def test_artifact_config_and_buckets(artifact_dir, port_service):
    art = port_service.artifact
    assert art.config == PyramidGANConfig(**dataclasses.asdict(JCFG))
    assert art.buckets == [1, 2]
    assert art.bucket_for(1) == 1 and art.bucket_for(2) == 2
    with pytest.raises(ValueError):
        art.bucket_for(3)


def test_http_server_roundtrip(port_service):
    server = make_server(port_service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post(body, path="/generate"):
        return urllib.request.urlopen(urllib.request.Request(
            base + path, data=json.dumps(body).encode(), method="POST"),
            timeout=120)

    try:
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=30).read())
        assert health == {"status": "ok", "batch_buckets": [1, 2],
                          "platforms": ["cpu"], "weights": "external"}
        manifest = json.loads(urllib.request.urlopen(
            f"{base}/manifest", timeout=30).read())
        assert manifest["batch_buckets"] == [1, 2]

        reply = json.loads(post({"image_b64": _png_b64(2), "level": 6,
                                 "class_id": 1, "num_samples": 2}).read())
        assert reply["bucket"] == 2 and reply["class_id"] == 1
        assert [_decode(i).shape for i in reply["images"]] == [(256, 256, 3)] * 2

        for bad in ({"level": 0},                                 # no image
                    {"image_b64": "aGk=", "num_samples": 99},     # > buckets
                    {"image_b64": _png_b64(), "level": 9},        # bad level
                    {"image_b64": _png_b64(), "class_id": 365},   # bad class
                    {"image_b64": "aGk="}):                       # not an image
            with pytest.raises(urllib.error.HTTPError) as err:
                post(bad)
            assert err.value.code == 400, bad
        with pytest.raises(urllib.error.HTTPError) as err:
            post({}, path="/nope")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_in_memory_modules_and_bucket_padding():
    """A random-init model served without an artifact; batch 3 pads into the
    4-bucket and the padding does not reach the outputs."""
    cfg = PyramidGANConfig().tiny()
    g, v = make_models(cfg, CPU, torch.Generator().manual_seed(0))
    service = GenerateService(ServingArtifact.from_modules(g, v, (1, 4)))
    image = np.random.default_rng(3).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    three = service.generate_arrays(image, level=2, class_id=7,
                                    num_samples=3, seed=9)
    four = service.generate_arrays(image, level=2, class_id=7,
                                   num_samples=4, seed=9)
    assert three["bucket"] == four["bucket"] == 4
    assert three["fakes"].shape == (3, 256, 256, 3)
    assert np.isfinite(three["fakes"]).all()
    assert np.abs(three["fakes"]).max() <= 1.0
    np.testing.assert_allclose(three["fakes"], four["fakes"][:3], rtol=0,
                               atol=1e-6)
    auto = service.generate_arrays(image, level=0)
    assert 0 <= auto["class_id"] < cfg.num_classes
    with pytest.raises(ValueError):
        service.generate_arrays(image[:128], level=0)


def test_generate_cli_writes_pngs(tmp_path):
    from semantic_pyramid_for_image_generation_torch.cli import generate

    src = tmp_path / "in.png"
    Image.open(io.BytesIO(base64.b64decode(_png_b64(4, size=64)))).save(src)
    out = tmp_path / "out"
    assert generate.main([
        "--images", str(src), "--out", str(out), "--levels", "0,6",
        "--device", "cpu", "--channel_factor", "8", "--vgg_width_factor", "8",
        "--dtype", "float32", "--grid", "--load_pretrained_vgg16", ""]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["in_level0_s0.png", "in_level6_s0.png", "in_sweep.png"]
    assert Image.open(out / "in_level6_s0.png").size == (256, 256)


def test_concurrent_clients_each_get_their_own_response():
    """Six threads post distinct /generate requests at once to the HTTP
    server on the CPU plain path. The service serializes the model calls
    through one lock; each reply must be the one its request gets alone
    (PNG for PNG, exactly), and the six requests' images all differ, so a
    reply handed to the wrong client would show."""
    cfg = PyramidGANConfig().tiny()
    g, v = make_models(cfg, CPU, torch.Generator().manual_seed(0))
    service = GenerateService(ServingArtifact.from_modules(g, v, (1, 2)))
    requests = [{"image_b64": _png_b64(i % 2), "level": i % 7,
                 "class_id": None if i == 5 else i, "num_samples": 1 + i % 2,
                 "seed": 10 + i} for i in range(6)]
    want = [service.generate(r) for r in requests]
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    replies, errors = [None] * len(requests), []
    barrier = threading.Barrier(len(requests))

    def client(i):
        try:
            barrier.wait(timeout=30)
            body = json.dumps(requests[i]).encode()
            replies[i] = json.loads(urllib.request.urlopen(
                urllib.request.Request(url, data=body, method="POST"),
                timeout=300).read())
        except Exception as e:  # reported below, in the test's thread
            errors.append((i, e))

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not errors, errors
    for got, w in zip(replies, want):
        assert got == w
    firsts = [r["images"][0] for r in replies]
    assert len(set(firsts)) == len(firsts)


# ---------------------------------------------------------------- (h) -----


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(no_cuda, artifact_dir,
                                                        tmp_path):
    from semantic_pyramid_for_image_generation_torch.cli import generate, serve
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        serve_artifact,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        resolve_device,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingArtifact(artifact_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_artifact(artifact_dir, port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--artifact", artifact_dir, "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--images", str(tmp_path), "--out", str(tmp_path)])
    assert resolve_device("cpu") == CPU
