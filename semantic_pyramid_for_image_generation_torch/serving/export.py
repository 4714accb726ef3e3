"""The serving-artifact reader.

Reads a JAX serving artifact directory written with `weights="external"`
(`manifest.json` plus `weights.npz`, whose keys are flax paths: `g/params/...`,
`g/spectral/...`, `g/batch_stats/...`, `vgg/...`) and builds the port's
Generator and VGG16 from those weights through the weight bridge. The
`.jaxexp` programs are not read: the port runs its own modules. Routing keeps
the manifest's batch buckets: a call is zero-padded to the smallest bucket
that fits and the padding is sliced off (every per-sample path, including
eval-mode batch norm, is batch-independent).

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
from semantic_pyramid_for_image_generation_torch.train.step import (
    make_generate_fn,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
    resolve_device,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_state_dict_from_flax,
    vgg16_state_dict_from_flax,
)

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def config_from_manifest(manifest: dict) -> PyramidGANConfig:
    """The manifest's `config` echo is exactly the dataclass's init fields."""
    return PyramidGANConfig(**manifest["config"])


def _unflatten_paths(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


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

