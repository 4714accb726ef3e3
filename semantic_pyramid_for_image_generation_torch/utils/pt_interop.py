"""The weight bridge: JAX-package parameters and reference `.pt` files into
the port's state dicts.

The JAX package's variables are nested dicts of arrays (`params`,
`spectral`, `batch_stats`; a JAX serving artifact's `weights.npz` holds the
same trees under `g/` and `vgg/`). The mapping below is an own copy of the
JAX package's `utils/pt_interop.py::_Exporter`, which emits the reference
torch layout; the port's modules use that layout, so the result loads with
`strict=True`, and a reference `.pt` loads directly.

Layouts: flax conv HWIO -> torch OIHW; flax dense (in, out) -> torch
(out, in); spectral u/v, embeddings and BN statistics as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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


class _Exporter:
    def __init__(self, variables: Mapping[str, Any]):
        self.params = _flat(variables.get("params", {}))
        self.spectral = _flat(variables.get("spectral", {}))
        self.stats = _flat(variables.get("batch_stats", {}))
        self.sd: Dict[str, torch.Tensor] = {}

    def _spectral(self, src: str, dst: str) -> None:
        self.sd[f"{dst}.weight_u"] = _t(self.spectral[f"{src}/u"])
        self.sd[f"{dst}.weight_v"] = _t(self.spectral[f"{src}/v"])

    def sn_conv(self, src: str, dst: str) -> None:
        k = self.params[f"{src}/kernel"]
        self.sd[f"{dst}.weight_orig"] = _t(k.transpose(3, 2, 0, 1))
        self.sd[f"{dst}.bias"] = _t(self.params[f"{src}/bias"])
        self._spectral(src, dst)

    def sn_dense(self, src: str, dst: str) -> None:
        self.sd[f"{dst}.weight_orig"] = _t(self.params[f"{src}/kernel"].T)
        self.sd[f"{dst}.bias"] = _t(self.params[f"{src}/bias"])
        self._spectral(src, dst)

    def cbn(self, src: str, dst: str) -> None:
        self.sd[f"{dst}.embedding.weight"] = _t(self.params[f"{src}/embedding"])
        self.sd[f"{dst}.batch_norm.running_mean"] = _t(self.stats[f"{src}/mean"])
        self.sd[f"{dst}.batch_norm.running_var"] = _t(self.stats[f"{src}/var"])
        self.sd[f"{dst}.batch_norm.num_batches_tracked"] = torch.tensor(0)

    def bn(self, src: str, dst: str) -> None:
        self.sd[f"{dst}.weight"] = _t(self.params[f"{src}/scale"])
        self.sd[f"{dst}.bias"] = _t(self.params[f"{src}/bias"])
        self.sd[f"{dst}.running_mean"] = _t(self.stats[f"{src}/mean"])
        self.sd[f"{dst}.running_var"] = _t(self.stats[f"{src}/var"])
        self.sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def attention(self, src: str, dst: str) -> None:
        for name in ("query_convolution", "key_convolution",
                     "value_convolution", "attention_convolution"):
            self.sn_conv(f"{src}/{name}", f"{dst}.{name}")
        self.sd[f"{dst}.gamma"] = _t(self.params[f"{src}/gamma"])


def generator_state_dict_from_flax(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Generator variables {params, spectral, batch_stats} -> the port's
    Generator state dict (the reference key layout)."""
    e = _Exporter(variables)
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
    return e.sd


def vgg16_state_dict_from_flax(
        params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VGG16 params (`features_i/{kernel,bias}`, `classifier_i/...`; a
    {"params": ...} wrapper is accepted) -> the port's VGG16 state dict."""
    p = _flat(params.get("params", params))
    sd = {}
    for i in _VGG_CONVS:
        sd[f"vgg16.features.{i}.weight"] = _t(
            p[f"features_{i}/kernel"].transpose(3, 2, 0, 1))
        sd[f"vgg16.features.{i}.bias"] = _t(p[f"features_{i}/bias"])
    for i in _VGG_FCS:
        sd[f"vgg16.classifier.{i}.weight"] = _t(p[f"classifier_{i}/kernel"].T)
        sd[f"vgg16.classifier.{i}.bias"] = _t(p[f"classifier_{i}/bias"])
    return sd


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


def load_reference_gan_checkpoint(path: str, generator: torch.nn.Module) -> None:
    """Load the generator of a reference `checkpoint_XXX.pt` straight into the
    port's Generator (same keys, strict)."""
    generator.load_state_dict(load_torch_file(path)["generator"], strict=True)
