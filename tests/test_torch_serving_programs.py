"""The port's serving programs (serving/export.py: `torch.export` programs
per bucket, external or baked weights, the classifier) and their reader
(serving/program.py::ProgramArtifact), on the CPU at channels_factor=8,
vgg_width_factor=8 (tests/test_serving_export.py's widths).

One seeded port model (u/v advanced 10 power iterations, random batch-norm
statistics and CBN tables) is carried into the JAX package by its own
converters, as tests/test_torch_serving_export.py does; the JAX
`save_artifact(weights="external")` exports it and its `ServingArtifact`
runs it. Tolerances:
  * port program against the JAX program, fp32: 5e-6 absolute (two
    frameworks' float32 convolutions, summed in other orders); bf16: 0.05
    max, 0.005 mean (tests/test_bf16_rewrites.py's band: the two round in
    different places).
  * external program, baked program and the port's eager
    `make_generate_fn`: bitwise. They run the same ATen ops and the same
    custom ops on the same tensors; the program divides by the shipped
    sigma, which the writer computed as the eager layer does (u^T W v).
  * planted fault (tests/torch_program_faults.py): one spectral weight and
    another layer's sigma scaled by 2 in weights.npz. Eager modules whose u
    is scaled to keep u^T W v equal to the shipped sigmas (by 1/2 and 2:
    exact in float32) give the program's output bitwise, and the JAX
    program on the same weights.npz within 5e-6; the originals give
    something else.
  * bucket padding: the padding does not reach the outputs, 1e-6 absolute
    (a convolution at another batch may sum in another order).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.serving.export import (
    ServingArtifact as JaxServingArtifact,
    save_artifact as jax_save_artifact,
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
from semantic_pyramid_for_image_generation_torch.ops.cuda import (
    attention,
    pool,
    resize,
)
from semantic_pyramid_for_image_generation_torch.serving.export import (
    ServingArtifact,
    export_generate,
    save_artifact,
)
from semantic_pyramid_for_image_generation_torch.serving.program import (
    ProgramArtifact,
    load_artifact,
)
from semantic_pyramid_for_image_generation_torch.serving.server import (
    GenerateService,
    make_server,
)
from torch_program_faults import eager_on_planted, plant

REPO = Path(__file__).resolve().parents[1]
CFG = PyramidGANConfig(channels_factor=8, vgg_width_factor=8)
DTYPES = ("float32", "bfloat16")
CPU = torch.device("cpu")
FP32_ATOL = 5e-6
BAND_MAX, BAND_MEAN = 0.05, 0.005


def _config(dtype):
    return dataclasses.replace(CFG, compute_dtype=dtype)


@pytest.fixture(scope="module")
def nets():
    """{dtype: (G, VGG16)}: one seeded model in both compute dtypes."""
    g, v = make_models(CFG, CPU, torch.Generator().manual_seed(0))
    advance_spectral_norm_(g, 10)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in g.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith("embedding.weight"):
                t.add_(0.2 * torch.randn(t.shape, generator=gen))
    out = {"float32": (g, v)}
    g16, v16 = make_models(_config("bfloat16"), CPU)
    g16.load_state_dict(g.state_dict())
    v16.load_state_dict(v.state_dict())
    out["bfloat16"] = (g16, v16)
    return out


@pytest.fixture(scope="module")
def artifacts(nets, tmp_path_factory):
    """{(dtype, weights): dir} of the port's cpu programs at buckets 1, 2;
    the classifier with the external weights only (the baked ones are
    written with classifier=False)."""
    out = {}
    for dtype in DTYPES:
        for weights in ("external", "baked"):
            path = str(tmp_path_factory.mktemp(f"{dtype}_{weights}"))
            save_artifact(*nets[dtype], path, (1, 2), platforms=["cpu"],
                          weights=weights,
                          classifier=weights == "external")
            out[dtype, weights] = path
    return out


@pytest.fixture(scope="module")
def jax_artifacts(nets, tmp_path_factory):
    """{dtype: dir} of the JAX package's exported programs on the same
    weights, external, at buckets 1, 2 with the classifier."""
    g, v = nets["float32"]
    g_vars = convert_generator_state_dict(g.state_dict())
    state = types.SimpleNamespace(
        g_params=g_vars["params"], g_spectral=g_vars["spectral"],
        g_batch_stats=g_vars["batch_stats"],
        vgg_params=convert_vgg16_state_dict(v.state_dict())["params"])
    out = {}
    for dtype in DTYPES:
        path = str(tmp_path_factory.mktemp(f"jax_{dtype}"))
        jax_save_artifact(state, JaxConfig(**dataclasses.asdict(
            _config(dtype))), path, (1, 2), weights="external")
        out[dtype] = path
    return out


@pytest.fixture(scope="module")
def readers(artifacts):
    """{(dtype, weights): ProgramArtifact} on the CPU."""
    return {key: ProgramArtifact(path, "cpu")
            for key, path in artifacts.items()}


@pytest.fixture(scope="module")
def jax_readers(jax_artifacts):
    return {dtype: JaxServingArtifact(path)
            for dtype, path in jax_artifacts.items()}


def _inputs(batch, seed=3):
    rng = np.random.default_rng(seed)
    schedule = MaskSchedule(CFG)
    levels = [1, 4, 6][:batch]
    return (rng.uniform(-1, 1, (batch, 256, 256, 3)).astype(np.float32),
            schedule.batch([schedule.inference_masks(lv) for lv in levels]),
            np.eye(CFG.num_classes, dtype=np.float32)[[2, 5, 7][:batch]],
            rng.standard_normal((batch, CFG.latent_dim)).astype(np.float32))


def _rows(inputs, rows):
    images, masks, labels, noise = inputs
    return images[rows], [m[rows] for m in masks], labels[rows], noise[rows]


def _eager(generator, vgg, inputs, buckets=(1, 2)):
    return ServingArtifact.from_modules(generator, vgg, buckets).generate(
        *inputs)


def _jax(reader, inputs):
    return np.asarray(reader.generate(*inputs), np.float32)


def _hold(got, want, dtype):
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() <= FP32_ATOL, diff.max()
    else:
        assert diff.max() <= BAND_MAX and diff.mean() <= BAND_MEAN, (
            diff.max(), diff.mean())


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("weights", ["external", "baked"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_program_matches_the_jax_exported_program(readers, jax_readers,
                                                   dtype, weights, batch):
    inputs = _inputs(batch)
    got = readers[dtype, weights].generate(*inputs)
    assert got.shape == (batch, 256, 256, 3)
    assert got.dtype == getattr(torch, dtype)
    _hold(got, _jax(jax_readers[dtype], inputs), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_external_baked_and_eager_agree_bitwise(nets, readers, dtype):
    inputs = _inputs(2)
    eager = _eager(*nets[dtype], inputs)
    for weights in ("external", "baked"):
        got = readers[dtype, weights].generate(*inputs)
        torch.testing.assert_close(got, eager, rtol=0, atol=0)


def test_classifier_program_argmax(nets, readers, jax_readers):
    """The auto class: fc8 argmax of the classifier program, of the JAX
    classifier program and of the eager VGG16, on three images."""
    program = readers["float32", "external"]
    jax_artifact = jax_readers["float32"]
    eager = ServingArtifact.from_modules(*nets["float32"], (1,))
    images = _inputs(3)[0]
    classes = [program.classify(image) for image in images]
    assert classes == [jax_artifact.classify(image) for image in images]
    assert classes == [eager.classify(image) for image in images]


def _call_targets(path):
    program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


@pytest.mark.parametrize("file,want", [
    ("generate_b2.cpu.pt2", {"pooled_kv_attention": 1, "max_pool_2x2": 6,
                             "upsample_2x": 11}),
    ("classify_b1.cpu.pt2", {"max_pool_2x2": 5}),
])
def test_program_graph_calls_the_kernels(artifacts, file, want):
    """One custom-op node per kernel call of an eager request, and no plain
    version of a kernel (pairwise maxima, the resize matmuls, einsum or
    softmax) in the graph."""
    targets = _call_targets(os.path.join(artifacts["float32", "external"],
                                         file))
    kernels = {t.split(".")[1] for t in targets if t.startswith("spig.")}
    counts = {k: sum(t == f"spig.{k}.default" for t in targets)
              for k in kernels}
    assert counts == want
    plain = [t for t in targets if t.split(".")[1] in (
        "maximum", "matmul", "einsum", "softmax", "_softmax", "bmm")]
    assert plain == []


# the ops that lay weights out (transpose, channels_last copy): the prepare
# program's, never a generate program's
LAYOUT_OPS = ("aten.permute.default", "aten.numpy_T.default",
              "aten.t.default", "aten.transpose.int",
              "aten.contiguous.default", "aten.clone.default")


@pytest.mark.parametrize("weights", ["external", "baked"])
def test_generate_program_lays_no_weight_out(artifacts, weights):
    """The weights reach a generate program laid out: external ones by the
    prepare program, once at load; baked ones at export. No layout op takes
    a weight in the generate graph, and the prepare graph is layout ops."""
    path = artifacts["float32", weights]
    program = torch.export.load(os.path.join(path, "generate_b2.cpu.pt2"))
    signature = program.graph_signature
    if weights == "external":  # the tensors; images, 7 masks, labels, noise
        names = set(signature.user_inputs[:-10])
    else:
        names = set(signature.inputs_to_buffers)
    assert len(names) > 100
    users = {str(user.target) for node in program.graph.nodes
             if node.op == "placeholder" and node.name in names
             for user in node.users}
    assert "aten.div.Tensor" in users  # each spectral weight by its sigma
    assert not users & set(LAYOUT_OPS), users & set(LAYOUT_OPS)
    if weights == "external":
        prepare = _call_targets(os.path.join(path, "prepare.cpu.pt2"))
        assert prepare and set(prepare) <= set(LAYOUT_OPS), set(prepare)


def test_planted_weight_fault_reaches_the_program(nets, artifacts,
                                                  jax_artifacts, tmp_path):
    """The external program divides the weights it is given by the sigmas
    it is given: neither frozen at tracing nor recomputed from u/v
    (tests/torch_program_faults.py)."""
    inputs = _inputs(2)
    plant(artifacts["float32", "external"], tmp_path / "port")
    got = ProgramArtifact(str(tmp_path / "port"), "cpu").generate(*inputs)
    eager = eager_on_planted(str(tmp_path / "port"), CFG, CPU)
    torch.testing.assert_close(got, _eager(*eager, inputs), rtol=0, atol=0)
    original = _eager(*nets["float32"], inputs)
    assert (got - original).abs().max() > 1e-2
    plant(jax_artifacts["float32"], tmp_path / "jax")
    _hold(got, _jax(JaxServingArtifact(str(tmp_path / "jax")), inputs),
          "float32")


READER = r"""
import json, sys
import numpy as np
before = set(sys.modules)
from semantic_pyramid_for_image_generation_torch.serving.program import (
    load_artifact)
from semantic_pyramid_for_image_generation_torch.serving.server import (
    GenerateService)
artifact = load_artifact(sys.argv[1], "cpu")
inputs = np.load(sys.argv[2])
fakes = artifact.generate(inputs["images"], [inputs[f"m{i}"] for i in range(7)],
                          inputs["labels"], inputs["noise"])
np.save(sys.argv[3], fakes.float().numpy())
reply = GenerateService(artifact).generate_arrays(inputs["images"][0], level=3)
print(json.dumps({"type": type(artifact).__name__,
                  "class_id": reply["class_id"],
                  "imported": sorted(set(sys.modules) - before),
                  "modules": sorted(sys.modules)}))
"""


def test_loading_builds_no_model(artifacts, tmp_path):
    """A fresh process loads and runs the programs (and serves a request
    through them) without importing the model code, the train code or
    JAX, and computes what this process computes."""
    inputs = _inputs(2)
    np.savez(tmp_path / "inputs.npz", images=inputs[0], labels=inputs[2],
             noise=inputs[3], **{f"m{i}": m for i, m in enumerate(inputs[1])})
    path = artifacts["float32", "external"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-c", READER, path, str(tmp_path / "inputs.npz"),
         str(tmp_path / "fakes.npy")], capture_output=True, text=True,
        env=env, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    reply = json.loads(run.stdout.strip().splitlines()[-1])
    assert reply["type"] == "ProgramArtifact"
    port = "semantic_pyramid_for_image_generation_torch."
    for name in reply["modules"]:
        assert not name.startswith((port + "models", port + "train",
                                    port + "serving.export")), name
    assert not [n for n in reply["imported"] if n.split(".")[0] == "jax"]
    want = ProgramArtifact(path, "cpu").generate(*inputs)
    np.testing.assert_array_equal(np.load(tmp_path / "fakes.npy"),
                                  want.numpy())


def test_bucket_padding_and_routing(nets, tmp_path):
    """Batch 2 pads into the 3-bucket; the padding does not reach the
    outputs. A batch past the largest bucket raises."""
    path = str(tmp_path / "art")
    save_artifact(*nets["float32"], path, (3,), classifier=False)
    artifact = ProgramArtifact(path, "cpu")
    assert artifact.buckets == [3] and artifact.bucket_for(2) == 3
    inputs = _inputs(3)
    two = artifact.generate(*_rows(inputs, slice(0, 2)))
    three = artifact.generate(*inputs)
    assert two.shape == (2, 256, 256, 3)
    torch.testing.assert_close(two, three[:2], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        artifact.generate(*_rows(inputs, [0, 1, 2, 0]))
    with pytest.raises(ValueError, match="class_id"):
        artifact.classify(inputs[0][0])


def test_manifest_fields(artifacts):
    for (dtype, weights), path in artifacts.items():
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["weights"] == weights
        assert manifest["classifier"] == (weights == "external")
        assert manifest["platforms"] == ["cpu"]
        assert manifest["torch_version"] == torch.__version__
        assert manifest["config"]["compute_dtype"] == dtype
        assert manifest["entry"].startswith(
            "generate(prepare(weights), " if weights == "external" else
            "generate(images, ")
        files = sorted(p["file"] for p in manifest["programs"])
        want = ["generate_b1.cpu.pt2", "generate_b2.cpu.pt2"]
        if weights == "external":
            want = (["classify_b1.cpu.pt2"] + want
                    + ["prepare.cpu.pt2", "weights.npz"])
        assert sorted(os.listdir(path)) == sorted(want + ["manifest.json"])
        program = torch.export.load(os.path.join(path, files[0]))
        if weights == "baked":  # the weights live in the program
            assert len(program.state_dict) > 100
        else:  # graph only: no tensor but the two normalization constants
            assert program.state_dict == {}
            assert sum(c.numel() for c in program.constants.values()) == 6
            prepare = torch.export.load(os.path.join(path, files[-1]))
            assert prepare.state_dict == {} and not prepare.constants
    with pytest.raises(ValueError, match="load_artifact"):
        ServingArtifact(path, "cpu")
    assert type(load_artifact(path, "cpu")) is ProgramArtifact


def test_http_round_trip_over_programs(artifacts):
    service = GenerateService(load_artifact(artifacts["float32", "external"],
                                            "cpu"))
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=30).read())
        assert health == {"status": "ok", "batch_buckets": [1, 2],
                          "platforms": ["cpu"], "weights": "external"}
        import base64
        import io

        from PIL import Image

        pixels = np.random.default_rng(0).random((256, 256, 3)) * 255
        buf = io.BytesIO()
        Image.fromarray(pixels.astype(np.uint8)).save(buf, format="PNG")
        body = {"image_b64": base64.b64encode(buf.getvalue()).decode(),
                "level": 2, "num_samples": 2, "seed": 4}
        reply = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"{base}/generate", data=json.dumps(body).encode(),
            method="POST"), timeout=120).read())
        assert reply["bucket"] == 2 and len(reply["images"]) == 2
        assert 0 <= reply["class_id"] < CFG.num_classes
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_export_cli_baked_without_classifier(tmp_path, capsys):
    out = str(tmp_path / "art")
    assert export_serving.main([
        "--out", out, "--batch_sizes", "2", "--device", "cpu",
        "--platforms", "cpu", "--weights", "baked", "--no-classifier",
        "--channel_factor", "8", "--vgg_width_factor", "8",
        "--dtype", "float32", "--seed", "4"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["weights"] == "baked" and not printed["classifier"]
    assert printed["platforms"] == ["cpu"]
    assert sorted(os.listdir(out)) == ["generate_b2.cpu.pt2", "manifest.json"]
    assert list(printed["bytes"]) == ["generate_b2.cpu.pt2"]
    service = GenerateService(load_artifact(out, "cpu"))
    image = np.random.default_rng(0).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)
    reply = service.generate_arrays(image, level=3, class_id=1,
                                    num_samples=2)
    assert reply["fakes"].shape == (2, 256, 256, 3)
    assert np.isfinite(reply["fakes"]).all()
    with pytest.raises(ValueError, match="class_id"):
        service.generate_arrays(image, level=3)


def test_cuda_programs_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_serving.main([
            "--out", str(tmp_path / "art"), "--device", "cpu",
            "--platforms", "cuda", "--channel_factor", "8",
            "--vgg_width_factor", "8"])
    assert not (tmp_path / "art").exists()


def test_reader_raises_for_a_missing_platform_or_a_broken_program(
        artifacts, tmp_path, monkeypatch):
    path = tmp_path / "cuda_only"
    shutil.copytree(artifacts["float32", "external"], path)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["platforms"] = ["cuda"]
    for p in manifest["programs"]:
        p["platform"] = "cuda"
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="no program for platform 'cpu'"):
        ProgramArtifact(str(path), "cpu")
    with pytest.raises(ValueError, match="no program for platform 'cpu'"):
        load_artifact(str(path), "cpu")  # never rebuilds the modules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProgramArtifact(str(path), "cuda")
    broken = tmp_path / "broken"
    shutil.copytree(artifacts["float32", "external"], broken)
    (broken / "generate_b2.cpu.pt2").write_bytes(b"not a program")
    with pytest.raises(RuntimeError, match="generate_b2.cpu.pt2"):
        ProgramArtifact(str(broken), "cpu")


def test_export_refuses_sharded_or_training_modules(nets, tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    g, v = make_models(CFG, CPU)
    g.train()
    with pytest.raises(ValueError, match="eval-mode"):
        export_generate(g, v, 1)
    g.eval()
    for p in g.parameters():  # FSDP shards contiguous tensors only
        p.data = p.data.contiguous()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        fully_shard(g, mesh=init_device_mesh("cpu", (1,)))
        with pytest.raises(ValueError, match="sharded"):
            export_generate(g, v, 1)
        with pytest.raises(ValueError, match="sharded"):
            save_artifact(g, v, str(tmp_path / "art"))
    finally:
        dist.destroy_process_group()


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,args", [
    (pool._max_pool_2x2_op, lambda g, d: (_cl(torch.randn(
        2, 3, 6, 8, generator=g)).to(d),)),
    (pool._max_pool_2x2_backward_op, lambda g, d: (
        _cl(torch.randn(2, 3, 6, 8, generator=g)).to(d),
        torch.randn(2, 3, 3, 4, generator=g).to(d))),
    (resize._upsample_2x_op, lambda g, d: (_cl(torch.randn(
        2, 3, 5, 7, generator=g)).to(d),)),
    (resize._upsample_2x_backward_op, lambda g, d: (torch.randn(
        2, 3, 6, 8, generator=g).to(d),)),
    (attention._pooled_kv_attention_op, lambda g, d: tuple(
        torch.randn(2, n, c, generator=g).to(d)
        for n, c in ((16, 4), (4, 4), (4, 6)))),
], ids=["max_pool_2x2", "max_pool_2x2_backward", "upsample_2x",
        "upsample_2x_backward", "pooled_kv_attention"])
def test_custom_op_registration(op, args, dtype):
    """torch.library.opcheck: schema, fake implementation (shape, dtype and
    strides of the CPU implementation's output), autograd registration and
    the op under AOT dispatch, against the plain version on the CPU."""
    torch.library.opcheck(op, args(torch.Generator().manual_seed(0), dtype))
