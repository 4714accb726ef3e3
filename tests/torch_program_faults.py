"""The planted weight fault of the serving-program tests (JAX-free, so the
card's tests use it too): in an external artifact's weights.npz, one
spectral weight and another layer's shipped sigma are scaled by 2.

A program that divides the weights it is given by the sigmas it is given
then computes what eager modules compute on the same weights with u scaled
to keep u^T W v equal to the shipped sigmas: u by 1/2 where W doubled, by 2
where sigma doubled. Powers of two are exact in float32, so eager's sigma
equals the shipped one bitwise. A program with the tracing weights frozen
in, or one that recomputes sigma from u/v, gives the originals' output.
"""

import os
import shutil

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.serving.program import (
    unflatten_paths,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    generator_state_dict_from_flax,
    vgg16_state_dict_from_flax,
)

# (weights.npz key scaled by 2, the eager u that keeps sigma, its factor)
PLANTED = (("g/params/block_1/conv_1/kernel",
            "main_path.1.main_block.3.weight_u", 0.5),
           ("g/sigmas/block_3/conv_2/sigma",
            "main_path.4.main_block.6.weight_u", 2.0))


def plant(src: str, dst: str) -> None:
    """Copy the artifact at `src` to `dst` with the fault planted."""
    shutil.copytree(src, dst)
    with np.load(os.path.join(src, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    for key, _, _ in PLANTED:
        flat[key] = flat[key] * np.float32(2.0)
    np.savez(os.path.join(dst, "weights.npz"), **flat)


def eager_on_planted(path: str, config, device: torch.device):
    """(G, VGG16) in eval mode from the planted artifact at `path`, each
    planted layer's u scaled so that its u^T W v is the shipped sigma."""
    with np.load(os.path.join(path, "weights.npz")) as z:
        tree = unflatten_paths({k: z[k] for k in z.files})
    g, v = make_models(config, device)
    sd = generator_state_dict_from_flax(tree["g"])
    for _, u_key, factor in PLANTED:
        sd[u_key] = sd[u_key] * factor
    g.load_state_dict(sd)
    v.load_state_dict(vgg16_state_dict_from_flax(tree["vgg"]))
    return g, v
