"""The serving artifact's writer (`save_artifact`, `export_generate`,
`export_classify`) and its modules reader (`ServingArtifact`).

Counterpart of the JAX package's serving/export.py. The writer lowers the
generate path to one `torch.export` program per batch bucket and platform,
`generate_b{N}.{platform}.pt2` (per-image min-max, the frozen VGG-16
pyramid, the eval-mode Generator with each spectral weight divided by its
shipped sigma), and the auto-class classifier to `classify_b1.{platform}.
pt2` (images -> fc8 logits). The five kernels are torch custom ops
(`ops/cuda`), so a program calls them as single nodes: a `cuda` program
launches the port's kernels, a `cpu` program runs their plain versions.
Callers pass latent noise, so serving is deterministic.

Weights ship one of two ways (`weights=`):

  * "external" (the default): `save_artifact` writes the weight tree of
    `serving_weights` (the JAX package's flax layout, `g/params/...`,
    `g/spectral/...`, `g/batch_stats/...`, `g/sigmas/...`, `vgg/...`) once
    to `weights.npz` for every bucket, and a `prepare.{platform}.pt2`
    program that lays it out for the port's layers (transposes,
    channels_last), run once when the artifact is read. Each generate
    program takes what prepare returns as its first input (the classifier
    its `vgg.` entries) and holds no tensor of its own beyond a few
    constants.
  * "baked": the tensors, laid out once at export, are the program's own
    state and its `.pt2` carries them.

Either way the program divides each spectral weight by the shipped
`g/sigmas`, as the JAX program does, and reads the shipped batch-norm
statistics: the modules are run through `torch.func.functional_call` on the
tree's tensors, never on their own (the eval-mode cache `weight_sn` of
models/layers.py would freeze the tracing weights into the program).

`serving/program.py::load_artifact` reads an artifact: one whose manifest
lists programs with `ProgramArtifact`, which builds no model, and one
without (a JAX package artifact) with `ServingArtifact`, which builds the
port's Generator and VGG16 from `weights.npz` through the weight bridge,
as `ServingArtifact.from_modules` serves in-memory modules.
Routing keeps the manifest's batch buckets: a call is zero-padded to the
smallest bucket that fits and the padding is sliced off (every per-sample
path, including eval-mode batch norm, is batch-independent).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.ops.spectral_norm import (
    spectral_norm_weight,
    weight_matrix,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    is_sharded,
)
from semantic_pyramid_for_image_generation_torch.serving.program import (
    FORMAT_VERSION,
    MANIFEST,
    WEIGHTS,
    config_from_manifest,
    flatten_paths,
    program_file,
    read_manifest,
    unflatten_paths,
    vgg_tensors,
    weight_tree,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    ensure_m11_images,
    generate_nhwc,
    make_generate_fn,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_layout,
    generator_state_dict_from_flax,
    vgg16_flax_from_state_dict,
    vgg16_layout,
    vgg16_state_dict_from_flax,
)

PLATFORMS = ("cuda", "cpu")


def serving_weights(generator: Generator, vgg: VGG16) -> Dict:
    """The weight tree an artifact ships, in the JAX package's layout: the
    Generator's {params, spectral, batch_stats} bridged back to flax, its
    eval-mode sigmas (u^T W v from the stored u/v, no power iteration, as
    the JAX `compute_sigma_tree(update=False)`), and the VGG16 params; all
    float32 numpy arrays."""
    sd = generator.state_dict()
    layout = generator_layout()
    g = layout.flax_from_state_dict(sd)
    sigmas: Dict = {}
    for src, dst in layout.spectral:
        sigma, _, _ = spectral_norm_weight(
            weight_matrix(sd[f"{dst}.weight_orig"]), sd[f"{dst}.weight_u"],
            sd[f"{dst}.weight_v"], update=False)
        node = sigmas
        for key in src.split("/"):
            node = node.setdefault(key, {})
        node["sigma"] = np.asarray(sigma.cpu(), np.float32)
    g["sigmas"] = sigmas
    return {"g": g, "vgg": vgg16_flax_from_state_dict(vgg.state_dict())}


class _Generate(nn.Module):
    """The net a generate program runs: `make_generate_fn`'s body."""

    def __init__(self, generator: Generator, vgg: VGG16):
        super().__init__()
        self.generator, self.vgg = generator, vgg

    def forward(self, images, masks, labels, noise):
        return generate_nhwc(self.generator, self.vgg, images, masks, labels,
                             noise)


class _Classify(nn.Module):
    """The net a classifier program runs: NHWC images -> fc8 logits."""

    def __init__(self, vgg: VGG16):
        super().__init__()
        self.vgg = vgg

    def forward(self, images):
        return self.vgg(ensure_m11_images(images).permute(0, 3, 1, 2))[-1]


def _vgg_tensors(vgg_tree: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + k: v for k, v in
            vgg16_layout().tensors_from_flax({"params": vgg_tree}).items()}


def _generate_tensors(weights: Dict) -> Dict[str, torch.Tensor]:
    """`_Generate`'s tensors in the port's layout (transposed, channels_last)
    from the serving tree: the bridged parameters, u/v and statistics, each
    spectral layer's shipped sigma as its `weight_sigma`, and the VGG16's
    (whose `vgg.` part is `_Classify`'s, `vgg_tensors`)."""
    layout = generator_layout()
    tensors = {"generator." + k: v
               for k, v in layout.tensors_from_flax(weights["g"]).items()}
    for src, dst in layout.spectral:
        node = weights["g"]["sigmas"]
        for key in src.split("/"):
            node = node[key]
        tensors[f"generator.{dst}.weight_sigma"] = node["sigma"]
    tensors.update(_vgg_tensors(weights["vgg"], "vgg."))
    return tensors


class _Prepare(nn.Module):
    """The prepare program: the serving tree (weights.npz) -> the tensors
    of `_generate_tensors`, which the external generate and classify
    programs take. Run once, when the artifact is read."""

    def forward(self, weights):
        return _generate_tensors(weights)


class _Program(nn.Module):
    """What `torch.export` traces: `net` run through
    `torch.func.functional_call` on its tensors in the port's layout, keyed
    by the net's state-dict names: the program's first input ("external")
    or its own buffers ("baked", laid out once, at export). The net is held
    in a list, so none of its own tensors becomes the program's."""

    def __init__(self, net: nn.Module,
                 baked: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self._net = [net]
        self._baked = None if baked is None else {
            name.replace(".", "__"): name for name in baked}
        for buffer, name in (self._baked or {}).items():
            self.register_buffer(buffer, baked[name])

    def forward(self, *args):
        if self._baked is None:
            tensors, *args = args
        else:
            tensors = {name: getattr(self, buffer)
                       for buffer, name in self._baked.items()}
        return torch.func.functional_call(self._net[0], tensors, tuple(args))


def _check_exportable(generator: Generator, vgg: VGG16) -> None:
    if not isinstance(generator.config, PyramidGANConfig):
        raise ValueError(
            f"export serves the Semantic Pyramid GAN's generator, not a "
            f"{type(generator.config).__name__}'s: BigGAN-deep has no "
            "serving path")
    if generator.config != vgg.config:
        raise ValueError("generator and VGG16 configs differ")
    if generator.training or vgg.training:
        raise ValueError("export needs eval-mode modules (.eval())")
    if is_sharded(generator) or is_sharded(vgg):
        raise ValueError(
            "export needs whole modules, not modules sharded by "
            "parallel/mesh.py::shard_state: export from an unsharded copy "
            "(e.g. one restored from a checkpoint)")


def _generate_inputs(config: PyramidGANConfig, batch: int,
                     device: torch.device) -> tuple:
    """Example (images, masks 7-tuple, labels, noise) of the calling
    convention: float32, NHWC, masks shallow->deep as data/masks.py emits
    them."""
    s = config.image_size

    def zeros(*shape):
        return torch.zeros((batch,) + tuple(shape), device=device)

    return (zeros(s, s, config.out_channels),
            tuple(zeros(*shape) for shape in config.mask_shapes),
            zeros(config.num_classes), zeros(config.latent_dim))


def _platform_device(generator: Generator,
                     platform: Optional[str]) -> torch.device:
    """The device a `platform` program is traced on (default: the
    modules'); `cuda` without a card raises."""
    platform = platform or next(generator.parameters()).device.type
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}: {platform!r}")
    return resolve_device(platform)


def _check_graph_only(program: torch.export.ExportedProgram) -> None:
    if program.state_dict:
        raise RuntimeError("an external program captured tensors of its "
                           f"own: {sorted(program.state_dict)[:5]}")


def _export(entry: str, generator: Generator, vgg: VGG16, batch: int,
            tensors: Dict[str, torch.Tensor], device: torch.device,
            weights: str) -> torch.export.ExportedProgram:
    """One program, `entry` ("generate" or "classify") at `batch` rows,
    traced on `device`, where `tensors` (`_generate_tensors` of the serving
    weights) lie."""
    inputs = _generate_inputs(generator.config, batch, device)
    if entry == "generate":
        net = _Generate(generator, vgg)
    else:  # the classifier takes the images and the VGG16's tensors
        net, tensors, inputs = _Classify(vgg), vgg_tensors(tensors), inputs[:1]
    if weights == "external":
        program = torch.export.export(_Program(net), (tensors,) + inputs,
                                      strict=False)
        _check_graph_only(program)
    elif weights == "baked":
        program = torch.export.export(_Program(net, baked=tensors), inputs,
                                      strict=False)
    else:
        raise ValueError(f"weights must be 'baked' or 'external': {weights}")
    # a saved program would carry its tracing inputs, the weights included
    program.example_inputs = None
    return program


def _export_prepare(tree: Dict) -> torch.export.ExportedProgram:
    program = torch.export.export(_Prepare(), (tree,), strict=False)
    _check_graph_only(program)
    program.example_inputs = None
    return program


def _serving_tensors(generator: Generator, vgg: VGG16,
                     platform: Optional[str]):
    """(device, `_generate_tensors` of the serving weights on it) of a
    `platform` export."""
    _check_exportable(generator, vgg)
    device = _platform_device(generator, platform)
    tree = weight_tree(flatten_paths(serving_weights(generator, vgg)), device)
    return device, _generate_tensors(tree)


def export_generate(generator: Generator, vgg: VGG16, batch_size: int, *,
                    platform: Optional[str] = None,
                    weights: str = "baked") -> torch.export.ExportedProgram:
    """The generate path at one batch size as a `torch.export` program on
    `platform` (`cuda` or `cpu`; default: the modules' device type).
    weights="baked": generate(images, masks, labels, noise), the weights
    its own state; "external": generate(tensors, images, masks, labels,
    noise) with `tensors` what the prepare program of `save_artifact`
    makes of the weights."""
    device, tensors = _serving_tensors(generator, vgg, platform)
    return _export("generate", generator, vgg, batch_size, tensors, device,
                   weights)


def export_classify(generator: Generator, vgg: VGG16, batch_size: int, *,
                    platform: Optional[str] = None,
                    weights: str = "baked") -> torch.export.ExportedProgram:
    """The auto-class classifier, images (B, H, W, 3) -> fc8 logits, as a
    program; external, it first takes the `vgg_tensors` of what the
    prepare program makes."""
    device, tensors = _serving_tensors(generator, vgg, platform)
    return _export("classify", generator, vgg, batch_size, tensors, device,
                   weights)


def save_artifact(generator: Generator, vgg: VGG16, out_dir: str,
                  batch_sizes: Sequence[int] = (1,), *,
                  platforms: Optional[Sequence[str]] = None,
                  weights: str = "external",
                  classifier: bool = True) -> Dict:
    """Export one generate program per batch bucket and platform (default:
    the modules' device type), with `classify_b1` unless classifier=False
    and, when the weights are external, the `prepare` program, and write
    them, `weights.npz` when the weights are external, and `manifest.json`
    to `out_dir`; returns the manifest."""
    _check_exportable(generator, vgg)
    config = generator.config
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    if weights not in ("baked", "external"):
        raise ValueError(f"weights must be 'baked' or 'external': {weights}")
    platforms = list(dict.fromkeys(
        platforms or [next(generator.parameters()).device.type]))
    devices = [_platform_device(generator, p) for p in platforms]
    os.makedirs(out_dir, exist_ok=True)
    flat = flatten_paths(serving_weights(generator, vgg))
    if weights == "external":
        np.savez(os.path.join(out_dir, WEIGHTS), **flat)
    entries = [("generate", b) for b in buckets]
    if classifier:
        entries.append(("classify", 1))
    if weights == "external":
        entries.insert(0, ("prepare", None))
    programs = []
    for platform, device in zip(platforms, devices):
        tree = weight_tree(flat, device)
        tensors = _generate_tensors(tree)
        for entry, batch in entries:
            name = program_file(entry, batch, platform)
            program = (_export_prepare(tree) if entry == "prepare" else
                       _export(entry, generator, vgg, batch, tensors, device,
                               weights))
            torch.export.save(program, os.path.join(out_dir, name))
            programs.append({"file": name, "entry": entry, "batch": batch,
                             "platform": platform})
    manifest = {
        "format_version": FORMAT_VERSION,
        "entry": ("generate(images, masks[7], labels, noise) -> fakes"
                  if weights == "baked" else
                  "generate(prepare(weights), images, masks[7], labels, "
                  "noise) -> fakes"),
        "weights": weights,
        "classifier": classifier,
        "batch_buckets": buckets,
        "platforms": platforms,
        "programs": programs,
        "torch_version": torch.__version__,
        "config": dataclasses.asdict(config),
        "shapes": {
            "images": [None, config.image_size, config.image_size,
                       config.out_channels],
            "masks": [[None] + list(s) for s in config.mask_shapes],
            "labels": [None, config.num_classes],
            "noise": [None, config.latent_dim],
        },
        "notes": (
            "written by the PyTorch port: torch.export programs (.pt2), "
            "read with torch.export.load on the torch of torch_version, "
            "the port's custom ops (torch.ops.spig.*) registered; the "
            "port's serving/program.py::ProgramArtifact reads them. "
            "External weights: weights.npz by flax path, passed as the "
            "nested tree (keys sorted) to the prepare program once; what "
            "it returns (the port's layout, by state-dict name) goes "
            "first to every generate program, its vgg. entries to the "
            "classifier. masks are the shallow->deep 7-tuple the data "
            "pipeline emits (data/masks.py); noise is caller-provided "
            "N(0,1) so serving is deterministic; images are float32 in "
            "[-1,1]."
        ),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingArtifact:
    """Routes `generate` calls to the right batch bucket and runs the port's
    eval-mode modules on `device`: built from an artifact without programs
    (`weights.npz`), or `from_modules`. An artifact whose manifest lists
    programs is read by `serving/program.py::load_artifact`, which serves
    them with `ProgramArtifact`; here it raises."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        manifest = read_manifest(path)
        if manifest.get("programs"):
            raise ValueError(
                f"{path} lists programs: read it with serving/program.py::"
                "load_artifact (ProgramArtifact), which builds no model")
        if manifest.get("weights") != "external":
            raise ValueError("the port reads artifacts exported with "
                             "weights='external' (weights.npz); baked "
                             "weights live inside the JAX programs")
        device = resolve_device(device)
        config = config_from_manifest(manifest)
        with np.load(os.path.join(path, WEIGHTS)) as z:
            tree = unflatten_paths({k: z[k] for k in z.files})
        generator, vgg = make_models(config, device)
        generator.load_state_dict(generator_state_dict_from_flax(tree["g"]))
        vgg.load_state_dict(vgg16_state_dict_from_flax(tree["vgg"]))
        self._setup(generator, vgg, manifest)

    @classmethod
    def from_modules(cls, generator: Generator, vgg: VGG16,
                     batch_buckets: Sequence[int]) -> "ServingArtifact":
        """Serve in-memory eval-mode modules (one device, one config)."""
        device = next(generator.parameters()).device
        manifest = {
            "format_version": FORMAT_VERSION,
            "weights": "in-memory",
            "classifier": True,
            "batch_buckets": sorted(set(int(b) for b in batch_buckets)),
            "platforms": [device.type],
            "config": dataclasses.asdict(generator.config),
        }
        self = cls.__new__(cls)
        self._setup(generator, vgg, manifest)
        return self

    def _setup(self, generator: Generator, vgg: VGG16, manifest: dict) -> None:
        if generator.config != vgg.config:
            raise ValueError("generator and VGG16 configs differ")
        buckets = manifest["batch_buckets"]
        if not buckets or min(buckets) < 1:
            raise ValueError(f"batch buckets must be positive: {buckets}")
        self.manifest = manifest
        self.config = generator.config
        self.buckets = sorted(buckets)
        self.device = next(generator.parameters()).device
        self.vgg = vgg
        self._generate = make_generate_fn(generator, vgg)

    def bucket_for(self, batch: int) -> int:
        fitting = [b for b in self.buckets if b >= batch]
        if not fitting:
            raise ValueError(
                f"batch {batch} exceeds largest bucket {max(self.buckets)}")
        return min(fitting)

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(self.device, torch.float32)

    def generate(self, images, masks, labels, noise) -> torch.Tensor:
        """(B, H, W, 3) fakes in the compute dtype, on the artifact's device;
        arguments as make_generate_fn takes them (numpy or tensors)."""
        batch = int(np.shape(images)[0])
        bucket = self.bucket_for(batch)

        def pad(x):
            x = self._tensor(x)
            if bucket == batch:
                return x
            widths = [0, 0] * (x.dim() - 1) + [0, bucket - batch]
            return torch.nn.functional.pad(x, widths)

        out = self._generate(pad(images), [pad(m) for m in masks],
                             pad(labels), pad(noise))
        return out[:batch]

    def classify(self, image) -> int:
        """fc8 argmax class of ONE (H, W, 3) conditioning image."""
        x = self._tensor(image)[None].permute(0, 3, 1, 2)
        with torch.inference_mode(), exact_float32():
            logits = self.vgg(x)[-1]
        return int(logits[0].float().argmax())
