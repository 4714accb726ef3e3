"""The port's cli/convert_checkpoint.py against the JAX package's converters.

`vgg-pt` reads a VGG-16 `.pt` with caffe keys, bare torchvision keys or the
reference's `vgg16.*` keys, or a whole-module pickle, and writes a
normalized `vgg16.*` state dict. Held two ways, exactly (the conversion
only renames keys and copies float32 values): the JAX package's
`convert_vgg16_state_dict` of the output equals that of the source leaf for
leaf, and the port's VGG16 loads the output with strict=True.
`inception-pt` writes the state dict the port's Inception feature extractor
loads strictly, and the JAX package's `convert_inception_state_dict` of it
equals that of the torchvision source. The orbax modes raise.
"""

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.models.inception import (
    convert_inception_state_dict,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.cli import convert_checkpoint
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.inception import (
    make_inception,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16

CFG = PyramidGANConfig(vgg_width_factor=16)
CAFFE = {"features.0": "conv1_1", "features.2": "conv1_2",
         "features.5": "conv2_1", "features.7": "conv2_2",
         "features.10": "conv3_1", "features.12": "conv3_2",
         "features.14": "conv3_3", "features.17": "conv4_1",
         "features.19": "conv4_2", "features.21": "conv4_3",
         "features.24": "conv5_1", "features.26": "conv5_2",
         "features.28": "conv5_3", "classifier.0": "fc6",
         "classifier.3": "fc7", "classifier.6": "fc8a"}


def _vgg(seed=0):
    model = VGG16(CFG)
    model.initialize(torch.Generator().manual_seed(seed))
    return model


def _bare(sd):
    return {k[len("vgg16."):]: v for k, v in sd.items()}


def _caffe(sd):
    out = {}
    for key, value in _bare(sd).items():
        layer, _, tail = key.rpartition(".")
        out[f"{CAFFE[layer]}.{tail}"] = value
    return out


def _leaves(variables):
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    walk("", variables)
    return flat


@pytest.mark.parametrize("layout", ["caffe", "torchvision", "reference",
                                    "pickle"])
def test_vgg_pt_matches_the_jax_conversion(tmp_path, layout):
    model = _vgg()
    sd = model.state_dict()
    src, dst = tmp_path / "src.pt", tmp_path / "dst.pt"
    source = {"caffe": _caffe(sd), "torchvision": _bare(sd),
              "reference": sd, "pickle": model}[layout]
    torch.save(source, src)
    assert convert_checkpoint.main(["vgg-pt", str(src), str(dst)]) == 0
    out = torch.load(dst, weights_only=True)
    assert sorted(out) == sorted(sd)
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in out.values())
    want = _leaves(convert_vgg16_state_dict(
        sd if layout == "pickle" else source))
    got = _leaves(convert_vgg16_state_dict(out))
    assert got.keys() == want.keys() and len(got) == 32
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    fresh = VGG16(CFG)
    fresh.load_state_dict(out, strict=True)


def test_vgg_pt_refuses_other_state_dicts(tmp_path):
    src = tmp_path / "src.pt"
    sd = _vgg().state_dict()
    del sd["vgg16.classifier.6.bias"]
    torch.save(sd, src)
    with pytest.raises(KeyError, match="missing"):
        convert_checkpoint.main(["vgg-pt", str(src), str(tmp_path / "d.pt")])
    torch.save({"generator.weight": torch.zeros(1)}, src)
    with pytest.raises(KeyError):
        convert_checkpoint.main(["vgg-pt", str(src), str(tmp_path / "d.pt")])


def test_inception_pt_loads_strictly_and_matches_the_jax_conversion(tmp_path):
    sd = make_inception(torch.device("cpu"),
                        rng=torch.Generator().manual_seed(1)).state_dict()
    source = dict(sd)  # a torchvision file also holds the aux head and fc
    source["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    source["fc.weight"] = torch.zeros(1000, 2048)
    source["fc.bias"] = torch.zeros(1000)
    src, dst = tmp_path / "inception.pth", tmp_path / "features.pt"
    torch.save(source, src)
    assert convert_checkpoint.main(["inception-pt", str(src), str(dst)]) == 0
    out = torch.load(dst, weights_only=True)
    assert out.keys() == sd.keys()
    make_inception(torch.device("cpu"), state_dict=out)
    want = _leaves(convert_inception_state_dict(source))
    got = _leaves(convert_inception_state_dict(out))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("mode", ["pt-to-orbax", "orbax-to-pt", "vgg-to-pt"])
def test_orbax_modes_raise(tmp_path, mode):
    with pytest.raises(NotImplementedError, match="JAX package"):
        convert_checkpoint.main([mode, str(tmp_path / "a"),
                                 str(tmp_path / "b")])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("flag", [["--channel_factor", "2"], ["--lr", "1e-4"]])
def test_flags_of_the_orbax_modes_are_refused(tmp_path, flag):
    """The JAX converter's orbax modes read these; the port has none of
    them, so the flags are refused rather than silently ignored."""
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["vgg-pt", str(tmp_path / "a"),
                                 str(tmp_path / "b")] + flag)
    assert not list(tmp_path.iterdir())
