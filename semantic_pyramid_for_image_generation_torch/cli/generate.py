"""Generation CLI: semantic-pyramid image generation from reference images.

Same flags as the JAX package's cli/generate.py. For each input image and
each requested level, draws `--num_samples` latents and writes PNGs (plus an
optional sweep grid). The class conditioning defaults to the VGG's own fc8
prediction of the input image, overridable with --class_id. Without
checkpoints the weights are a random init from --seed.

    python -m semantic_pyramid_for_image_generation_torch.cli.generate \
        --images photo.jpg --out generated --levels 0,3,6
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=str, required=True,
                   help="input image file or directory")
    p.add_argument("--out", type=str, default="generated")
    p.add_argument("--levels", type=str, default="all",
                   help="comma-separated deep->shallow stage indices 0..6, "
                        "or 'all' (0 = fc8 semantics only, 6 = pool1 near-copy)")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--class_id", type=int, default=None,
                   help="condition class (default: VGG fc8 argmax per image)")
    p.add_argument("--load_checkpoint", type=str, default=None,
                   help="reference .pt checkpoint (its generator is loaded)")
    p.add_argument("--load_pretrained_vgg16", type=str,
                   default="pre_trained_models/vgg_places_365_fine_tuned.pt")
    p.add_argument("--grid", default=False, action="store_true",
                   help="also write one image x level sweep grid per input")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--channel_factor", type=float, default=1.0)
    p.add_argument("--vgg_width_factor", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    return p


def _load_image(path: str, size: int):
    import numpy as np
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
    mn, mx = arr.min(), arr.max()
    return 2.0 * (arr - mn) / max(mx - mn, 1e-12) - 1.0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
    from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
    from semantic_pyramid_for_image_generation_torch.eval.grid import (
        normalize_0_1_np,
        save_inference_grid,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        resolve_device,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_reference_gan_checkpoint,
        load_torch_file,
        vgg16_state_dict_from_torch,
    )

    device = resolve_device(args.device)
    config = PyramidGANConfig(
        channels_factor=args.channel_factor, compute_dtype=args.dtype,
        vgg_width_factor=args.vgg_width_factor)

    # ---- weights: random init from the seed unless files are given --------
    rng = torch.Generator(device).manual_seed(args.seed)
    generator, vgg = make_models(config, device, rng)
    if args.load_pretrained_vgg16 and os.path.exists(args.load_pretrained_vgg16):
        vgg.load_state_dict(vgg16_state_dict_from_torch(
            load_torch_file(args.load_pretrained_vgg16)))
    if args.load_checkpoint:
        if not args.load_checkpoint.endswith(".pt"):
            raise ValueError("the port loads reference .pt checkpoints; "
                             "convert orbax checkpoints with the JAX package's "
                             "cli.convert_checkpoint")
        generator.load_state_dict(
            load_reference_gan_checkpoint(args.load_checkpoint)["generator"],
            strict=True)
    model = ServingArtifact.from_modules(generator, vgg, batch_buckets=(1,))

    # ---- inputs --------------------------------------------------------------
    if os.path.isdir(args.images):
        paths = sorted(
            os.path.join(args.images, f) for f in os.listdir(args.images)
            if os.path.splitext(f)[1].lower() in
            {".jpg", ".jpeg", ".png", ".bmp", ".webp"})
    else:
        paths = [args.images]
    if not paths:
        raise ValueError(f"no images under {args.images}")
    levels = (list(range(7)) if args.levels == "all"
              else [int(x) for x in args.levels.split(",")])

    schedule = MaskSchedule(config)
    os.makedirs(args.out, exist_ok=True)
    noise_rng = torch.Generator().manual_seed(args.seed + 1)

    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        image = _load_image(path, config.image_size)
        class_id = (model.classify(image) if args.class_id is None
                    else args.class_id)
        onehot = np.zeros((1, config.num_classes), np.float32)
        onehot[0, class_id] = 1.0
        cells = []
        for level in levels:
            masks = [m[None] for m in schedule.inference_masks(level)]
            for s in range(args.num_samples):
                noise = torch.randn((1, config.latent_dim), generator=noise_rng)
                fake = model.generate(image[None], masks, onehot, noise)
                fake = fake[0].float().cpu().numpy()
                cells.append(fake)
                out_img = (normalize_0_1_np(fake[None])[0] * 255.0
                           + 0.5).astype(np.uint8)
                out_path = os.path.join(
                    args.out, f"{name}_level{level}_s{s}.png")
                Image.fromarray(out_img).save(out_path)
                print(f"{out_path} (class {class_id})")
        if args.grid:
            grid_path = os.path.join(args.out, f"{name}_sweep.png")
            save_inference_grid(np.stack(cells), grid_path,
                                nrow=args.num_samples * len(levels))
            print(grid_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
