"""The serving-program reader: an artifact's `torch.export` programs, run
without building a model.

An artifact written by `serving/export.py::save_artifact` holds, beside
`manifest.json`:

    generate_b{N}.{platform}.pt2  generate(tensors, images, masks[7],
                                  labels, noise) -> fakes, one per batch
                                  bucket and platform (`cuda`, `cpu`)
    classify_b1.{platform}.pt2    classify(vgg_tensors(tensors), images) ->
                                  fc8 logits, the auto class (unless
                                  exported with classifier=False)
    prepare.{platform}.pt2        tensors = prepare(weights): the weight
                                  tree laid out for the port's layers
    weights.npz                   the weight tree by flax path

when the weights are "external"; "baked" programs carry their tensors,
laid out, and take none (no prepare, no weights.npz).

`ProgramArtifact` loads the programs of its device's platform with
`torch.export.load`, uploads `weights.npz` to the device and runs the
prepare program on it once, and then runs the others. It imports torch,
numpy, the config dataclass and the kernels' op registrations
(`ops/cuda`, which the programs call as `torch.ops.spig.*`), never the
model code: no module is built, and an artifact without a program for the
device's platform raises. `load_artifact` is the one router: an artifact
whose manifest lists programs goes to `ProgramArtifact`, one that lists
none (a JAX package artifact) to the modules reader,
serving/export.py::ServingArtifact.

A program is read only on a torch of the same major.minor version as the
one that wrote it (`torch_version` in the manifest): `torch.export`'s
format is not promised across versions, so `ProgramArtifact` refuses any
other with an error that names both versions and the
`cli/export_serving.py` command that writes the programs anew. An artifact
without programs (a JAX package artifact: `weights.npz` only) carries no
torch version and goes on to the modules reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.ops import (  # noqa: F401
    cuda as _kernel_ops,  # registers torch.ops.spig.*, which programs call
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
    resolve_device,
)

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
WEIGHTS = "weights.npz"


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest['format_version']} "
                         f"!= supported {FORMAT_VERSION}")
    return manifest


def major_minor(version: str) -> tuple:
    """(major, minor) of a torch version string such as '2.11.0+cu128'."""
    major, minor = version.split("+")[0].split(".")[:2]
    return int(major), int(minor)


def export_command(path: str, manifest: dict) -> str:
    """The cli/export_serving.py command that writes the artifact's programs
    again, from the files its weights came from."""
    config = manifest["config"]
    return (
        "python -m semantic_pyramid_for_image_generation_torch.cli."
        f"export_serving --out {path} --batch_sizes "
        f"{','.join(str(b) for b in manifest['batch_buckets'])} "
        f"--platforms {','.join(manifest['platforms'])} "
        f"--weights {manifest['weights']} "
        f"--{'' if manifest['classifier'] else 'no-'}classifier "
        f"--dtype {config['compute_dtype']} "
        f"--channel_factor {config['channels_factor']} "
        f"--vgg_width_factor {config['vgg_width_factor']} "
        "--load_checkpoint <G checkpoint .pt> "
        "--load_pretrained_vgg16 <VGG-16 .pt>")


def check_torch_version(path: str, manifest: dict) -> None:
    """Raise unless the programs were written on this torch's major.minor."""
    written = manifest.get("torch_version", "unknown")
    running = torch.__version__
    if written == "unknown" or major_minor(written) != major_minor(running):
        raise ValueError(
            f"{path}: its programs were written by torch {written} and this "
            f"is torch {running}; torch.export programs are read only on "
            "the torch major.minor that wrote them. Write them again on "
            f"this torch: {export_command(path, manifest)}")


def config_from_manifest(manifest: dict) -> PyramidGANConfig:
    """The manifest's `config` echo is exactly the dataclass's init fields."""
    return PyramidGANConfig(**manifest["config"])


def program_file(entry: str, batch: Optional[int], platform: str) -> str:
    """`{entry}_b{batch}.{platform}.pt2`; the prepare program has no batch."""
    return (f"{entry}.{platform}.pt2" if batch is None else
            f"{entry}_b{batch}.{platform}.pt2")


def vgg_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The classifier's part of the prepared tensors, in their order."""
    return {k: v for k, v in tensors.items() if k.startswith("vgg.")}


def flatten_paths(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested string-keyed dicts -> {'a/b/c': leaf}."""
    flat = {}
    for key, node in tree.items():
        if "/" in key:
            raise ValueError(f"path separator in key {key!r}")
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            flat.update(flatten_paths(node, path))
        else:
            flat[path] = node
    return flat


def unflatten_paths(flat: Dict[str, object]) -> Dict:
    """{'a/b/c': leaf} -> nested dicts, keys in sorted order at every level:
    the order a program's weight input was traced with (its input spec
    names the keys in order), whatever order the file lists them in."""
    tree: Dict = {}
    for path in sorted(flat):
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = flat[path]
    return tree


def weight_tree(flat: Dict[str, np.ndarray], device: torch.device) -> Dict:
    """The weight input of an external program: float32 tensors on
    `device` in the key order it was traced with."""
    return unflatten_paths({k: torch.from_numpy(np.asarray(v, np.float32))
                            .to(device) for k, v in flat.items()})


def read_weights(path: str, device: torch.device) -> Dict:
    with np.load(os.path.join(path, WEIGHTS)) as z:
        return weight_tree({k: z[k] for k in z.files}, device)


def _load_program(path: str, name: str):
    """The callable module of one saved program; raises naming the file."""
    file = os.path.join(path, name)
    try:
        return torch.export.load(file).module()
    except Exception as e:  # any failure to read is the artifact's fault
        raise RuntimeError(f"{file}: the program failed to load "
                           f"({type(e).__name__}: {e})") from e


class ProgramArtifact:
    """Routes `generate` calls to the program of the smallest batch bucket
    that fits (zero-padding the batch, slicing the padding off: every
    per-sample path is batch-independent) and `classify` to the classifier
    program, on `device`."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        self.manifest = read_manifest(path)
        check_torch_version(path, self.manifest)
        self.device = resolve_device(device)  # cuda without a card raises
        platform = self.device.type
        programs = [p for p in self.manifest.get("programs", [])
                    if p["platform"] == platform]
        if not programs:
            raise ValueError(
                f"{path}: no program for platform {platform!r} (the "
                f"artifact's platforms: {self.manifest.get('platforms')}); "
                f"export one with --platforms {platform}")
        self.config = config_from_manifest(self.manifest)
        self.buckets = sorted(self.manifest["batch_buckets"])
        by_entry = {(p["entry"], p["batch"]): p["file"] for p in programs}
        external = self.manifest["weights"] == "external"
        wanted = [("generate", b) for b in self.buckets]
        if self.manifest["classifier"]:
            wanted.append(("classify", 1))
        if external:
            wanted.append(("prepare", None))
        missing = [program_file(e, b, platform) for e, b in wanted
                   if (e, b) not in by_entry]
        if missing:
            raise ValueError(f"{path}: the manifest lists no {missing}")
        self._generate = {b: _load_program(path, by_entry[("generate", b)])
                          for b in self.buckets}
        self._classify = (_load_program(path, by_entry[("classify", 1)])
                          if self.manifest["classifier"] else None)
        self.weights: Optional[Dict] = None  # the prepared tensors
        if external:
            self.weights = self._run(
                _load_program(path, by_entry[("prepare", None)]), None,
                read_weights(path, self.device))
        self._vgg_weights = (None if self.weights is None else
                             vgg_tensors(self.weights))

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

    def _run(self, program, weights, *args):
        if weights is not None:
            args = (weights,) + args
        with torch.inference_mode(), exact_float32():
            return program(*args)

    def generate(self, images, masks: Sequence, labels, noise) -> torch.Tensor:
        """(B, H, W, 3) fakes in the compute dtype, on the artifact's device;
        arguments as `make_generate_fn` takes them (numpy or tensors)."""
        batch = int(np.shape(images)[0])
        bucket = self.bucket_for(batch)

        def pad(x):
            x = self._tensor(x)
            if bucket == batch:
                return x
            widths = [0, 0] * (x.dim() - 1) + [0, bucket - batch]
            return torch.nn.functional.pad(x, widths)

        out = self._run(self._generate[bucket], self.weights, pad(images),
                        tuple(pad(m) for m in masks), pad(labels), pad(noise))
        return out[:batch]

    def classify(self, image) -> int:
        """fc8 argmax class of ONE (H, W, 3) conditioning image."""
        if self._classify is None:
            raise ValueError("artifact exported without a classifier "
                             "program; pass class_id explicitly")
        logits = self._run(self._classify, self._vgg_weights,
                           self._tensor(image)[None])
        return int(logits[0].float().argmax())


def load_artifact(path: str, device: str | torch.device = "cuda"):
    """The reader for the artifact at `path`: `ProgramArtifact` when its
    manifest lists programs, else the modules reader (serving/export.py::
    ServingArtifact, imported only then), which builds the port's
    Generator and VGG16 from `weights.npz`."""
    if read_manifest(path).get("programs"):
        return ProgramArtifact(path, device)
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
    )

    return ServingArtifact(path, device)
