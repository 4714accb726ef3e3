"""Export the generate path as a serving artifact of `torch.export`
programs.

    python -m semantic_pyramid_for_image_generation_torch.cli.export_serving \
        --load_checkpoint runs/models_X/checkpoint_003.pt \
        --load_pretrained_vgg16 pre_trained_models/vgg_places_365_fine_tuned.pt \
        --out artifacts/generate --batch_sizes 1,8,64 --platforms cuda

Counterpart of the JAX package's cli/export_serving.py. Writes
`<out>/manifest.json`, one `generate_b{N}.{platform}.pt2` program per batch
bucket and platform (serving/export.py), `classify_b1.{platform}.pt2`
(images -> fc8 logits, so serving can derive class_id) unless
`--no-classifier`, and with `--weights external` (the default) one
`weights.npz` in the JAX package's flax layout and a
`prepare.{platform}.pt2` program that lays it out for the port's layers
once, when the artifact is read, for every program to take as its first
input; `--weights baked` puts the weights, laid out, inside each program.
`cuda` programs are exported on the card (raises without one), `cpu`
programs on the CPU. The port's `cli/serve.py` serves the programs without
building a model (serving/program.py). Without both weight files the
weights are a random init from `--seed` (a warning says so).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, required=True,
                   help="artifact output directory")
    p.add_argument("--batch_sizes", type=str, default="1",
                   help="comma-separated batch buckets")
    p.add_argument("--platforms", type=str, default=None,
                   help="comma-separated program targets, cuda and/or cpu "
                        "(default: the platform of --device)")
    p.add_argument("--weights", type=str, default="external",
                   choices=["external", "baked"],
                   help="'external' (default): graph-only programs + one "
                        "weights.npz shared by all buckets; 'baked': "
                        "self-contained programs that carry the weights")
    p.add_argument("--classifier", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="also export classify_b1 (images -> fc8 logits) so "
                        "serving can derive class_id")
    p.add_argument("--load_checkpoint", type=str, default=None,
                   help="reference-layout .pt checkpoint (its generator)")
    p.add_argument("--load_pretrained_vgg16", type=str, default=None,
                   help="fine-tuned VGG16 .pt (vgg_places_365_fine_tuned)")
    p.add_argument("--seed", type=int, default=0,
                   help="init seed for any weights not covered by a load")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    p.add_argument("--channel_factor", type=float, default=1.0)
    p.add_argument("--vgg_width_factor", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        save_artifact,
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
    if args.load_checkpoint and not args.load_checkpoint.endswith(".pt"):
        raise ValueError(
            f"--load_checkpoint {args.load_checkpoint}: the port reads "
            "reference-layout .pt checkpoints only; convert an orbax "
            "checkpoint with the JAX package's cli/convert_checkpoint.py "
            "orbax-to-pt")
    config = PyramidGANConfig(
        channels_factor=args.channel_factor, compute_dtype=args.dtype,
        vgg_width_factor=args.vgg_width_factor)
    generator, vgg = make_models(config, device,
                                 torch.Generator(device).manual_seed(args.seed))
    if args.load_pretrained_vgg16:
        vgg.load_state_dict(vgg16_state_dict_from_torch(
            load_torch_file(args.load_pretrained_vgg16)), strict=True)
    if args.load_checkpoint:
        generator.load_state_dict(
            load_reference_gan_checkpoint(args.load_checkpoint)["generator"],
            strict=True)
    if not (args.load_checkpoint and args.load_pretrained_vgg16):
        print("WARNING: exporting with randomly initialized weights "
              "(no --load_checkpoint / --load_pretrained_vgg16): the "
              "artifact is a pipeline smoke, not a trained model",
              file=sys.stderr)

    manifest = save_artifact(
        generator, vgg, args.out,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        platforms=args.platforms.split(",") if args.platforms else None,
        weights=args.weights, classifier=args.classifier)
    files = [p["file"] for p in manifest["programs"]]
    if manifest["weights"] == "external":
        files.append("weights.npz")
    print(json.dumps({"out": args.out,
                      "batch_buckets": manifest["batch_buckets"],
                      "platforms": manifest["platforms"],
                      "weights": manifest["weights"],
                      "classifier": manifest["classifier"],
                      "bytes": {f: os.path.getsize(os.path.join(args.out, f))
                                for f in files}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
