"""VGG-16 smoke test: one batch of `<data>/train` through the fine-tuned
classifier in eval mode; prints the argmax, the top-10 and the labels.

    python -m semantic_pyramid_for_image_generation_torch.cli.vgg16_infer \
        --data places365_standard \
        --load_vgg16 pre_trained_models/vgg_places_365_fine_tuned.pt

Counterpart of the JAX package's cli/vgg16_infer.py, with the same flags;
`--device` defaults to `cuda` and raises without a card, and
`--num_classes` (default 365, the JAX CLI's fixed head) reads a head of
another size. As in the reference, the inputs are ImageNet-normalized by
the pipeline and again inside VGG16.forward. Without the `.pt` the weights
are a random init.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VGG16 inference smoke test")
    p.add_argument("--data", type=str, default="places365_standard")
    p.add_argument("--load_vgg16", type=str,
                   default="pre_trained_models/vgg_places_365_fine_tuned.pt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    p.add_argument("--vgg_width_factor", type=int, default=1)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=365)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from semantic_pyramid_for_image_generation_torch.cli.vgg16_finetune import (
        batch_to_device,
        build_model,
    )
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.image_folder import (
        ImageFolder,
        ImageFolderLoader,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        exact_float32,
        resolve_device,
    )

    device = resolve_device(args.device)
    config = PyramidGANConfig(vgg_width_factor=args.vgg_width_factor,
                              image_size=args.image_size,
                              num_classes=args.num_classes)
    if not os.path.exists(args.load_vgg16):
        print(f"{args.load_vgg16} not found; using random init")
    model = build_model(config, device, args.load_vgg16).eval()

    ds = ImageFolder(os.path.join(args.data, "train"), config.image_size)
    loader = ImageFolderLoader(ds, args.batch_size, num_workers=4)
    images, labels = next(iter(loader))
    x, _ = batch_to_device(images, labels, device)
    with torch.inference_mode(), exact_float32():
        logits = model(x).float().cpu().numpy()
    print("predictions (argmax):", logits.argmax(-1))
    top10 = (-logits).argsort(axis=-1)[:, :10]
    print("predictions (top-10):", top10)
    print("labels:", labels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
