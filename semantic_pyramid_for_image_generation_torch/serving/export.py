"""The serving artifact: its writer (`save_artifact`) and its reader
(`ServingArtifact`).

An artifact is a directory of `manifest.json` plus `weights.npz`, whose keys
are flax paths: `g/params/...`, `g/spectral/...`, `g/batch_stats/...`,
`g/sigmas/...` (the eval-mode spectral sigmas) and `vgg/...`, the layout
the JAX package's `save_artifact(weights="external")` writes.

The reader takes a JAX artifact or one the port wrote, and builds the port's
Generator and VGG16 from `weights.npz` through the weight bridge. The
`.jaxexp` programs of a JAX artifact are not read: the port runs its own
modules. Routing keeps the manifest's batch buckets: a call is zero-padded to
the smallest bucket that fits and the padding is sliced off (every
per-sample path, including eval-mode batch norm, is batch-independent).

The writer is the counterpart of the JAX package's `save_artifact`: the same
manifest fields and the same `weights.npz`, bridged back from the port's
state dicts. It writes no `.jaxexp` programs, so the JAX package's reader,
which loads those, cannot read a port artifact; the port's reader can.

`ServingArtifact.from_modules` serves in-memory modules the same way, so a
random-init model can be served without an artifact on disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

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
from semantic_pyramid_for_image_generation_torch.train.step import (
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
    vgg16_state_dict_from_flax,
)

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def config_from_manifest(manifest: dict) -> PyramidGANConfig:
    """The manifest's `config` echo is exactly the dataclass's init fields."""
    return PyramidGANConfig(**manifest["config"])


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested string-keyed dicts -> {'a/b/c': leaf}."""
    flat = {}
    for key, node in tree.items():
        if "/" in key:
            raise ValueError(f"path separator in key {key!r}")
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            flat.update(_flatten_with_paths(node, path))
        else:
            flat[path] = node
    return flat


def _unflatten_paths(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


@torch.no_grad()
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


def save_artifact(generator: Generator, vgg: VGG16, out_dir: str,
                  batch_sizes: Sequence[int] = (1,)) -> Dict:
    """Write `<out_dir>/weights.npz` and `<out_dir>/manifest.json` for the
    given modules (one config) and batch buckets; returns the manifest."""
    if generator.config != vgg.config:
        raise ValueError("generator and VGG16 configs differ")
    config = generator.config
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "weights.npz"),
             **_flatten_with_paths(serving_weights(generator, vgg)))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "entry": "generate(weights, images, masks[7], labels, noise) -> fakes",
        "weights": "external",
        "classifier": True,
        "batch_buckets": buckets,
        "platforms": [],
        "programs": [],
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
            "written by the PyTorch port: weights.npz only, no .jaxexp "
            "programs (the JAX package's reader needs them; the port's "
            "ServingArtifact reads this artifact). The fc8 classifier is "
            "vgg/classifier_6. masks are the shallow->deep 7-tuple the data "
            "pipeline emits (data/masks.py); noise is caller-provided "
            "N(0,1) so serving is deterministic; images are float in "
            "[-1,1]."
        ),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingArtifact:
    """Routes `generate` calls to the right batch bucket and runs the port's
    eval-mode modules on `device`."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"artifact format {manifest['format_version']} "
                             f"!= supported {_FORMAT_VERSION}")
        if manifest.get("weights") != "external":
            raise ValueError("the port reads artifacts exported with "
                             "weights='external' (weights.npz); baked "
                             "weights live inside the JAX programs")
        device = resolve_device(device)
        config = config_from_manifest(manifest)
        with np.load(os.path.join(path, "weights.npz")) as z:
            tree = _unflatten_paths({k: z[k] for k in z.files})
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
            "format_version": _FORMAT_VERSION,
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

