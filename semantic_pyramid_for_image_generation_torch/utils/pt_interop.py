"""The weight bridge: JAX-package parameters and reference `.pt` files into
the port's state dicts and back, and the reference-layout GAN checkpoint
the port writes and reads (`reference_gan_checkpoint`,
`load_reference_gan_checkpoint`).

The JAX package's variables are nested dicts of arrays (`params`,
`spectral`, `batch_stats`; a serving artifact's `weights.npz` holds the
same trees under `g/` and `vgg/`). The key maps below (`generator_layout`,
`discriminator_layout`) are an own copy of the JAX package's
`utils/pt_interop.py::_Exporter` and its generator and discriminator
exports, which emit the reference torch layout; the port's modules use that
layout, so the result loads with `strict=True`, and a reference `.pt` loads
directly. The same maps run backwards for the serving-artifact writer
(`generator_flax_from_state_dict`, `vgg16_flax_from_state_dict`).

Layouts: flax conv HWIO <-> torch OIHW; flax dense (in, out) <-> torch
(out, in); spectral u/v, embeddings and BN statistics as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    full_tensor,
)

_VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_FCS = (0, 3, 6)

# caffe layer names -> torchvision vgg16 module indices (the Places365
# caffemodel dump names its layers this way)
_CAFFE_VGG16_LAYERS = {
    "conv1_1": "features.0", "conv1_2": "features.2",
    "conv2_1": "features.5", "conv2_2": "features.7",
    "conv3_1": "features.10", "conv3_2": "features.12",
    "conv3_3": "features.14",
    "conv4_1": "features.17", "conv4_2": "features.19",
    "conv4_3": "features.21",
    "conv5_1": "features.24", "conv5_2": "features.26",
    "conv5_3": "features.28",
    "fc6": "classifier.0", "fc7": "classifier.3", "fc8a": "classifier.6",
}


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _np(value: Any) -> np.ndarray:
    """A tensor or array as a float32 numpy copy on the host."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.array(value, dtype=np.float32, copy=True)


def _set_leaf(tree: Dict[str, Any], path: str, value: Any) -> None:
    *parents, last = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


# the layout transforms: flax -> torch, torch -> flax
_TO_TORCH = {"conv": lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
             "dense": lambda a: a.T,  # (in, out) -> (out, in)
             "same": lambda a: a}
_TO_FLAX = {"conv": lambda a: np.ascontiguousarray(a.transpose(2, 3, 1, 0)),
            "dense": lambda a: np.ascontiguousarray(a.T),
            "same": lambda a: a}
_COLLECTIONS = ("params", "spectral", "batch_stats")
# flax -> torch on tensors: the torch layout as a view, then the memory
# layout the port's modules hold (conv weights channels_last, dense weights
# contiguous (out, in)), so the values and strides are those of a loaded
# module's parameter
_TO_TORCH_TENSOR = {
    "conv": lambda t: t.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last),
    "dense": lambda t: t.T.contiguous(),
    "same": lambda t: t}


class _Layout:
    """The key map between a network's JAX variables and the port's state
    dict. `entries` lists (torch key, collection, flax path, kind) in state
    dict order; kind "conv" / "dense" / "same" names the layout transform,
    and kind "counter" a batch norm's `num_batches_tracked`, which the JAX
    package does not keep. `spectral` lists the (flax path, torch prefix) of
    every spectrally-normalized layer."""

    def __init__(self):
        self.entries: list = []
        self.spectral: list = []

    def _add(self, key: str, collection: Optional[str], path: Optional[str],
             kind: str = "same") -> None:
        self.entries.append((key, collection, path, kind))

    def _uv(self, src: str, dst: str) -> None:
        self._add(f"{dst}.weight_u", "spectral", f"{src}/u")
        self._add(f"{dst}.weight_v", "spectral", f"{src}/v")
        self.spectral.append((src, dst))

    def sn_conv(self, src: str, dst: str) -> None:
        self._add(f"{dst}.weight_orig", "params", f"{src}/kernel", "conv")
        self._add(f"{dst}.bias", "params", f"{src}/bias")
        self._uv(src, dst)

    def sn_dense(self, src: str, dst: str) -> None:
        self._add(f"{dst}.weight_orig", "params", f"{src}/kernel", "dense")
        self._add(f"{dst}.bias", "params", f"{src}/bias")
        self._uv(src, dst)

    def sn_embedding(self, src: str, dst: str) -> None:
        self._add(f"{dst}.weight_orig", "params", f"{src}/embedding")
        self._uv(src, dst)

    def cbn(self, src: str, dst: str) -> None:
        self._add(f"{dst}.embedding.weight", "params", f"{src}/embedding")
        self._add(f"{dst}.batch_norm.running_mean", "batch_stats", f"{src}/mean")
        self._add(f"{dst}.batch_norm.running_var", "batch_stats", f"{src}/var")
        self._add(f"{dst}.batch_norm.num_batches_tracked", None, None, "counter")

    def bn(self, src: str, dst: str) -> None:
        self._add(f"{dst}.weight", "params", f"{src}/scale")
        self._add(f"{dst}.bias", "params", f"{src}/bias")
        self._add(f"{dst}.running_mean", "batch_stats", f"{src}/mean")
        self._add(f"{dst}.running_var", "batch_stats", f"{src}/var")
        self._add(f"{dst}.num_batches_tracked", None, None, "counter")

    def attention(self, src: str, dst: str) -> None:
        for name in ("query_convolution", "key_convolution",
                     "value_convolution", "attention_convolution"):
            self.sn_conv(f"{src}/{name}", f"{dst}.{name}")
        self._add(f"{dst}.gamma", "params", f"{src}/gamma")

    def state_dict_from_flax(
            self, variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        flat = {c: _flat(variables.get(c, {})) for c in _COLLECTIONS}
        sd = {}
        for key, collection, path, kind in self.entries:
            sd[key] = (torch.tensor(0) if kind == "counter"
                       else _t(_TO_TORCH[kind](flat[collection][path])))
        return sd

    def tensors_from_flax(
            self, variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """`state_dict_from_flax` on a tree of tensors, in torch ops only
        (no numpy, no copy to the host): what a traced serving program runs
        on its weight inputs (serving/export.py). Batch-norm counters are
        left out."""
        sd = {}
        for key, collection, path, kind in self.entries:
            if kind != "counter":
                leaf = variables[collection]
                for name in path.split("/"):
                    leaf = leaf[name]
                sd[key] = _TO_TORCH_TENSOR[kind](leaf)
        return sd

    def flax_from_state_dict(
            self, sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
        tree: Dict[str, Dict[str, Any]] = {c: {} for c in _COLLECTIONS}
        for key, collection, path, kind in self.entries:
            if kind != "counter":
                _set_leaf(tree[collection], path,
                          _TO_FLAX[kind](_np(sd[key])))
        return {c: t for c, t in tree.items() if t}


def generator_layout() -> _Layout:
    """The JAX Generator's variables against the port's Generator state dict
    (the reference key layout)."""
    e = _Layout()
    e.sn_dense("linear_layer", "linear_layer")
    for i in (1, 2):
        e.sn_dense(f"linear_block_{i}/linear", f"linear_block_{i}.main_block.1")
        e.sn_dense(f"linear_block_{i}/masked_feature_mapping",
                   f"linear_block_{i}.masked_feature_mapping")
    e.sn_conv("convolution_layer", "convolution_layer.1")
    # main_path indices 0, 1, 2, 4, 5 are residual blocks; 3 is attention
    for block_idx, path_idx in enumerate((0, 1, 2, 4, 5)):
        src, dst = f"block_{block_idx}", f"main_path.{path_idx}"
        e.cbn(f"{src}/cbn_1", f"{dst}.main_block.0")
        e.sn_conv(f"{src}/conv_1", f"{dst}.main_block.3")
        e.cbn(f"{src}/cbn_2", f"{dst}.main_block.4")
        e.sn_conv(f"{src}/conv_2", f"{dst}.main_block.6")
        e.sn_conv(f"{src}/residual_conv", f"{dst}.residual_mapping.1")
        e.sn_conv(f"{src}/masked_feature_mapping",
                  f"{dst}.masked_feature_mapping")
    e.attention("self_attention", "main_path.3")
    e.bn("final_bn", "final_block.1")
    e.sn_conv("final_conv_1", "final_block.3")
    e.sn_conv("final_conv_2", "final_block.5")
    return e


def discriminator_layout() -> _Layout:
    """The JAX Discriminator's variables against the port's Discriminator
    state dict (the reference key layout)."""
    e = _Layout()
    e.sn_conv("block_0/conv_1", "layers.0.main_block.0")
    e.sn_conv("block_0/conv_2", "layers.0.main_block.2")
    e.sn_conv("block_0/residual_conv", "layers.0.residual_mapping")
    # layers indices 1, 2, 4-7 are residual blocks; 3 is attention
    for block_idx, path_idx in enumerate((1, 2, 4, 5, 6, 7), start=1):
        src, dst = f"block_{block_idx}", f"layers.{path_idx}"
        e.sn_conv(f"{src}/conv_1", f"{dst}.main_block.1")
        e.sn_conv(f"{src}/conv_2", f"{dst}.main_block.3")
        e.sn_conv(f"{src}/residual_conv", f"{dst}.residual_mapping")
    e.attention("self_attention", "layers.3")
    e.sn_dense("linear", "layers.11")
    e.sn_dense("classification", "classification")
    e.sn_embedding("embedding", "embedding")
    return e


# the torch dim that holds each flax axis, per layout kind
_FLAX_AXES = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


_KINDS: Dict[str, str] = {}


def _layout_kinds() -> Dict[str, str]:
    """Every G, D and VGG16 state-dict key -> its layout kind."""
    if not _KINDS:
        for layout in (generator_layout(), discriminator_layout(),
                       vgg16_layout()):
            _KINDS.update((key, kind) for key, _, _, kind in layout.entries)
    return _KINDS


def flax_axes(key: str, ndim: int) -> tuple:
    """The torch dims of the tensor at G, D or VGG16 state-dict key `key`
    in the order of its flax leaf's axes: flax axis j is torch dim
    `flax_axes(key, ndim)[j]`."""
    kind = _layout_kinds().get(key)
    if kind is None:
        raise KeyError(f"{key}: not a key of the generator, discriminator "
                       "or VGG16 layout")
    return _FLAX_AXES.get(kind, tuple(range(ndim)))


def generator_state_dict_from_flax(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Generator variables {params, spectral, batch_stats} -> the port's
    Generator state dict (the reference key layout)."""
    return generator_layout().state_dict_from_flax(variables)


def discriminator_state_dict_from_flax(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Discriminator variables {params, spectral} -> the port's
    Discriminator state dict (the reference key layout)."""
    return discriminator_layout().state_dict_from_flax(variables)


def generator_flax_from_state_dict(
        sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The inverse bridge: a port (or reference) Generator state dict -> the
    JAX Generator's variables {params, spectral, batch_stats} as float32
    numpy trees."""
    return generator_layout().flax_from_state_dict(sd)


def vgg16_layout() -> _Layout:
    """The JAX VGG16's params (`features_i/{kernel,bias}`,
    `classifier_i/...`, one collection "params") against the port's VGG16
    state dict."""
    e = _Layout()
    for prefix, indices, kind in (("features", _VGG_CONVS, "conv"),
                                  ("classifier", _VGG_FCS, "dense")):
        for i in indices:
            e._add(f"vgg16.{prefix}.{i}.weight", "params",
                   f"{prefix}_{i}/kernel", kind)
            e._add(f"vgg16.{prefix}.{i}.bias", "params", f"{prefix}_{i}/bias")
    return e


def vgg16_state_dict_from_flax(
        params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VGG16 params (`features_i/{kernel,bias}`, `classifier_i/...`; a
    {"params": ...} wrapper is accepted) -> the port's VGG16 state dict."""
    return vgg16_layout().state_dict_from_flax(
        {"params": params.get("params", params)})


def vgg16_flax_from_state_dict(
        sd: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse bridge: a port VGG16 state dict (`vgg16.*` keys) -> the
    JAX VGG16's params tree (`features_i/{kernel,bias}`, `classifier_i/...`)
    as float32 numpy arrays."""
    return vgg16_layout().flax_from_state_dict(sd)["params"]


def vgg16_state_dict_keys() -> list:
    """The 32 keys of the port's (and the reference's) VGG16 state dict."""
    return [key for key, *_ in vgg16_layout().entries]


def load_torch_file(path: str) -> Mapping[str, Any]:
    """torch.load a `.pt` file onto the CPU; a pickled whole module becomes its
    state dict. Load only files you trust: this unpickles."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj


def vgg16_state_dict_from_torch(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference VGG16 state dict (`vgg16.features.*`), a bare torchvision
    one (`features.*`) or caffe-named keys (`conv1_1.*`) -> the port's keys."""
    out = {}
    for key, value in sd.items():
        layer, _, tail = key.partition(".")
        if layer in _CAFFE_VGG16_LAYERS:
            key = f"{_CAFFE_VGG16_LAYERS[layer]}.{tail}"
        elif layer != "vgg16" and layer not in ("features", "classifier"):
            raise KeyError(f"not a VGG16 state dict key: {key}")
        out[key if key.startswith("vgg16.") else f"vgg16.{key}"] = value
    return out


def inception_state_dict_from_flax(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX InceptionV3Features variables {params, batch_stats} -> the
    torchvision-named state dict of the port's InceptionV3Features."""
    params = _flat(variables["params"])
    stats = _flat(variables["batch_stats"])
    sd = {}
    for path in params:
        if not path.endswith("/conv/kernel"):
            continue
        src = path[:-len("/conv/kernel")]
        dst = src.replace("/", ".")
        sd[f"{dst}.conv.weight"] = _t(params[path].transpose(3, 2, 0, 1))
        sd[f"{dst}.bn.weight"] = _t(params[f"{src}/bn_scale"])
        sd[f"{dst}.bn.bias"] = _t(params[f"{src}/bn_bias"])
        sd[f"{dst}.bn.running_mean"] = _t(stats[f"{src}/mean"])
        sd[f"{dst}.bn.running_var"] = _t(stats[f"{src}/var"])
        sd[f"{dst}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


# ---------------------------------------------------------------------------
# GAN checkpoints in the reference layout: checkpoint_XXX.pt holds
# {"generator", "discriminator", "generator_optimizer",
# "discriminator_optimizer"}; the port adds "step", which readers that look
# keys up by name ignore. torch Adam keys its slots by integer ids in the
# order of the parameters it was built with; a file's ids index the
# parameter keys of that file's own model state dict, in order.
# ---------------------------------------------------------------------------

GAN_CHECKPOINT_KEYS = ("generator", "discriminator", "generator_optimizer",
                       "discriminator_optimizer")
BUFFER_SUFFIXES = ("weight_u", "weight_v", "running_mean", "running_var",
                   "num_batches_tracked")


def parameter_keys(model_sd: Mapping[str, Any]) -> list:
    """The parameter keys of a G or D state dict, in its order: torch's
    state dict lists each module's parameters before its buffers and recurses
    in registration order, the order `parameters()` yields and torch Adam
    numbers; spectral u/v and batch-norm statistics are the only buffers."""
    return [k for k in model_sd if not k.endswith(BUFFER_SUFFIXES)]


def _to_cpu(obj):
    """Tensors in `obj` as CPU copies, a sharded one gathered whole
    (parallel/mesh.py::full_tensor: every rank calls this)."""
    if isinstance(obj, torch.Tensor):
        return full_tensor(obj.detach()).to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def adam_state_dict_in_module_order(optimizer: torch.optim.Optimizer,
                                    module: torch.nn.Module) -> Dict[str, Any]:
    """`optimizer.state_dict()` on the CPU, after checking that its ids
    number `module.parameters()` in order, so they index the parameter keys
    of `module.state_dict()` as the reference layout requires."""
    mine = [p for group in optimizer.param_groups for p in group["params"]]
    theirs = list(module.parameters())
    if len(mine) != len(theirs) or any(a is not b for a, b in zip(mine, theirs)):
        raise ValueError("the optimizer was not built on module.parameters() "
                         "in order")
    return _to_cpu(optimizer.state_dict())


def reference_gan_checkpoint(state) -> Dict[str, Any]:
    """A TrainState as the reference `checkpoint_XXX.pt` layout: G and D
    state dicts and torch Adam state dicts, whole tensors on the CPU, plus
    its `step`. The JAX package's `load_reference_gan_checkpoint(
    include_optimizer=True)` reads the file with the moments on the right
    parameters. A sharded state gives the same dict as its unsharded twin;
    every rank gathers it, so every rank calls this."""
    return {
        "generator": _to_cpu(state.generator.state_dict()),
        "discriminator": _to_cpu(state.discriminator.state_dict()),
        "generator_optimizer": adam_state_dict_in_module_order(
            state.g_optimizer, state.generator),
        "discriminator_optimizer": adam_state_dict_in_module_order(
            state.d_optimizer, state.discriminator),
        "step": int(state.step),
    }


def load_reference_gan_checkpoint(path: str) -> Dict[str, Any]:
    """A reference, JAX-package or port `checkpoint_XXX.pt` as a dict with the
    G and D state dicts and both optimizer state dicts ({} where the file has
    none), and `step` where the file has it. Load only files you trust: this
    unpickles."""
    ckpt = load_torch_file(path)
    missing = [k for k in ("generator", "discriminator") if k not in ckpt]
    if missing:
        raise KeyError(f"{path} is not a GAN checkpoint: no {missing}")
    out = {k: ckpt.get(k) or {} for k in GAN_CHECKPOINT_KEYS}
    if "step" in ckpt:
        out["step"] = int(ckpt["step"])
    return out
