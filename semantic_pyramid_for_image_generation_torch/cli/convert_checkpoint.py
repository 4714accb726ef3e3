"""Checkpoint conversion, the modes without orbax.

    python -m semantic_pyramid_for_image_generation_torch.cli.convert_checkpoint \
        vgg-pt vgg_places_365.pt vgg16_normalized.pt

Counterpart of the JAX package's cli/convert_checkpoint.py. Modes:
  vgg-pt        a VGG-16 `.pt` (a state dict with reference `vgg16.*`, bare
                torchvision `features.*` or caffe `conv1_1.*` keys, or a
                whole-module pickle) -> a normalized `vgg16.*` state dict
                that the port's VGG16 and the reference load with
                strict=True
  inception-pt  a torchvision inception_v3 `.pth` state dict -> the state
                dict the port's Inception feature extractor (FID) loads with
                strict=True
  pt-to-orbax, orbax-to-pt, vgg-to-pt
                read or write orbax checkpoints, the JAX package's format:
                they raise here; run them with the JAX package's
                cli/convert_checkpoint.py

Both modes unpickle their source: convert only files you trust.
"""

from __future__ import annotations

import argparse
import sys

ORBAX_MODES = ("pt-to-orbax", "orbax-to-pt", "vgg-to-pt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["pt-to-orbax", "orbax-to-pt", "vgg-pt",
                                    "vgg-to-pt", "inception-pt"])
    p.add_argument("src")
    p.add_argument("dst")
    return p


def vgg16_pt(src) -> dict:
    """A VGG-16 `.pt` in any of the accepted layouts -> the normalized
    `vgg16.*` state dict (float32 CPU tensors), checked to hold exactly the
    VGG-16 keys."""
    import torch

    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
        vgg16_state_dict_from_torch,
        vgg16_state_dict_keys,
    )

    sd = vgg16_state_dict_from_torch(load_torch_file(src))
    want = vgg16_state_dict_keys()
    if set(sd) != set(want):
        raise KeyError(f"{src}: not a VGG-16 state dict; missing "
                       f"{sorted(set(want) - set(sd))[:4]}, unexpected "
                       f"{sorted(set(sd) - set(want))[:4]}")
    return {k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32)
            .contiguous().clone() for k in want}


def inception_pt(src) -> dict:
    """A torchvision inception_v3 state dict -> the port's Inception feature
    extractor's state dict, checked by a strict load."""
    import torch

    from semantic_pyramid_for_image_generation_torch.models.inception import (
        InceptionV3Features,
        torchvision_features_state_dict,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
    )

    sd = torchvision_features_state_dict(load_torch_file(src))
    with torch.device("meta"):  # checks keys and shapes, allocates nothing
        InceptionV3Features().load_state_dict(sd, strict=True, assign=True)
    return {k: torch.as_tensor(v).detach().to("cpu").contiguous().clone()
            for k, v in sd.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode in ORBAX_MODES:
        raise NotImplementedError(
            f"{args.mode}: orbax checkpoints are the JAX package's format, "
            "and the PyTorch port reads and writes .pt only; run this mode "
            "with the JAX package's cli/convert_checkpoint.py")

    import torch

    if args.mode == "vgg-pt":
        torch.save(vgg16_pt(args.src), args.dst)
        print(f"wrote VGG16 state dict {args.dst} (vgg16.* keys; the port's "
              "VGG16 and the reference load it with strict=True)")
    else:  # inception-pt
        torch.save(inception_pt(args.src), args.dst)
        print(f"wrote Inception FID-backbone state dict {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
