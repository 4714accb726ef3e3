"""Training CLI: train, validate (FID) and draw the sweep grid, with the flags
of the JAX package's cli/main.py.

    python -m semantic_pyramid_for_image_generation_torch.cli.main \
        --train --test --path_to_places365 places365_standard

The same flags, dests and defaults as the JAX package's `build_parser`,
except:
  * `--device` defaults to `cuda` and raises when there is no card (pass
    `--device cpu` to run on the CPU, through the kernels' plain versions);
  * `--load_checkpoint` takes reference-layout `.pt` files (the reference's,
    the JAX package's or the port's), Adam moments included; an orbax
    directory raises;
  * `--pallas` is accepted; `--no-pallas` on `cuda` raises: the port has no
    kernel-free path on the card;
  * modes the port does not have yet raise NotImplementedError: `--fsdp` > 1
    and `--multihost` (multi-device training), `--fused_d`, `--remat_vgg`
    and `--remat_blocks` (perf modes);
  * `--gpus_to_use` and `--use_data_parallel` are accepted and ignored, as
    in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Semantic Pyramid for Image Generation — PyTorch + CUDA")
    # --- the reference's flags ---
    p.add_argument("--train", default=False, action="store_true",
                   help="Train network")
    p.add_argument("--test", default=False, action="store_true",
                   help="Test network (FID + sample grid)")
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-05)
    p.add_argument("--channel_factor", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    p.add_argument("--gpus_to_use", type=str, default="",
                   help="accepted for reference compatibility; ignored")
    p.add_argument("--use_data_parallel", default=False, action="store_true",
                   help="accepted for compatibility; ignored (one device)")
    p.add_argument("--load_checkpoint", type=str, default=None,
                   help="reference-layout .pt checkpoint (G, D and Adam)")
    p.add_argument("--load_pretrained_vgg16", type=str,
                   default="pre_trained_models/vgg_places_365_fine_tuned.pt")
    p.add_argument("--path_to_places365", type=str, default="places365_standard")
    p.add_argument("--epochs", type=int, default=50)
    # --- the JAX package's additions ---
    p.add_argument("--w_rec", type=float, default=0.1)
    p.add_argument("--w_div", type=float, default=0.1)
    p.add_argument("--validate_after_n_iterations", type=int, default=100_000)
    p.add_argument("--log_every", type=int, default=50,
                   help="fetch step metrics in one host copy every N steps "
                        "(1 = the reference's per-iteration sync)")
    p.add_argument("--save_model_after_n_epochs", type=int, default=1,
                   help="checkpoint cadence in epochs")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--pallas", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="the hand-written CUDA kernels (the only path on the "
                        "card; --no-pallas raises there)")
    p.add_argument("--save_data_path", type=str, default="saved_data")
    p.add_argument("--load_inception", type=str, default=None,
                   help="torchvision inception_v3 .pt state dict for FID")
    p.add_argument("--allow_random_fid", default=False, action="store_true",
                   help="permit FID with a RANDOMLY initialized Inception "
                        "backbone (pipeline smoke only, not a standard FID); "
                        "without it, --test/validation needs --load_inception")
    p.add_argument("--fid_images", type=int, default=6000)
    p.add_argument("--fid_device_stats", default=False, action="store_true",
                   help="reduce the FID moments on the device (float32 "
                        "eigh) instead of the host (float64 sqrtm)")
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--vgg_width_factor", type=int, default=1,
                   help="debug: divide VGG widths (CPU-scale smoke runs)")
    p.add_argument("--auto_resume", type=str, default=None,
                   help="models dir to auto-restore the newest checkpoint from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compat_inference_indices", default=False,
                   action="store_true",
                   help="bug-compat: draw the 7 grid samples from "
                        "range(n_val_batches) like the reference")
    # --- perf modes ---
    p.add_argument("--canonical_projection", default=False, action="store_true",
                   help="canonical (B,1) projection-discriminator head instead "
                        "of the reference's (B,B,128) broadcast quirk")
    p.add_argument("--fused_d", default=False, action="store_true",
                   help="not in the port yet (raises)")
    p.add_argument("--remat_vgg", default=False, action="store_true",
                   help="not in the port yet (raises)")
    p.add_argument("--remat_blocks", default=False, action="store_true",
                   help="not in the port yet (raises)")
    p.add_argument("--compact_feed", default=False, action="store_true",
                   help="feed uint8 images/masks and normalize on device")
    p.add_argument("--tensorboard", default=False, action="store_true",
                   help="also stream metrics to TensorBoard under "
                        "<metrics dir>/tensorboard")
    p.add_argument("--multihost", default=False, action="store_true",
                   help="not in the port yet (raises)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="not in the port yet: values above 1 raise")
    return p


def check_supported(args) -> None:
    """Raise for flags of modes the port does not have yet."""
    waiting = [(args.fsdp > 1, "--fsdp > 1", "13 (multi-device training)"),
               (args.multihost, "--multihost", "13 (multi-device training)"),
               (args.fused_d, "--fused_d", "6 (perf modes)"),
               (args.remat_vgg, "--remat_vgg", "6 (perf modes)"),
               (args.remat_blocks, "--remat_blocks", "6 (perf modes)")]
    for given, flag, item in waiting:
        if given:
            raise NotImplementedError(
                f"{flag}: not in the PyTorch port yet (ROADMAP Queue 1, item "
                f"{item})")
    if not args.pallas and args.device.startswith("cuda"):
        raise ValueError("--no-pallas: the port has no kernel-free path on "
                         "the card; its kernels' plain versions run on the "
                         "CPU (--device cpu)")
    if args.load_checkpoint and not args.load_checkpoint.endswith(".pt"):
        raise ValueError(
            f"--load_checkpoint {args.load_checkpoint}: the port reads "
            "reference-layout .pt checkpoints only; the port's "
            "cli/convert_checkpoint.py has no orbax modes, so convert an "
            "orbax checkpoint with the JAX package's "
            "cli/convert_checkpoint.py orbax-to-pt")


def config_from_args(args):
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )

    return PyramidGANConfig(
        channels_factor=args.channel_factor, compute_dtype=args.dtype,
        vgg_width_factor=args.vgg_width_factor,
        compat_projection=not args.canonical_projection)


def build_trainer(args):
    """Flags -> a fully wired Trainer (loaders, weight files, checkpoint
    restore): everything main() does before train() / validate()."""
    check_supported(args)
    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
        restore_checkpoint,
    )
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
        param_count,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        resolve_device,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
        vgg16_state_dict_from_torch,
    )

    device = resolve_device(args.device)
    config = config_from_args(args)
    state = init_train_state(config, device, lr=args.lr, seed=args.seed)
    if args.load_pretrained_vgg16 and os.path.exists(args.load_pretrained_vgg16):
        state.vgg.load_state_dict(vgg16_state_dict_from_torch(
            load_torch_file(args.load_pretrained_vgg16)), strict=True)
        print(f"Loaded pretrained VGG16 from {args.load_pretrained_vgg16}")
    inception = None
    if args.load_inception and os.path.exists(args.load_inception):
        inception = load_torch_file(args.load_inception)

    train_loader = Places365Loader(
        Places365(args.path_to_places365, "train.txt", config),
        batch_size=args.batch_size, shuffle=True, drop_last=True,
        num_workers=args.num_workers, compact_feed=args.compact_feed)
    val_loader = Places365Loader(
        Places365(args.path_to_places365, "val.txt", config,
                  max_length=args.fid_images, validation=True),
        batch_size=2 * args.batch_size, shuffle=True, drop_last=False,
        num_workers=args.num_workers, compact_feed=args.compact_feed)

    trainer = Trainer(
        config, train_loader, val_loader,
        lr=args.lr, w_rec=args.w_rec, w_div=args.w_div, seed=args.seed,
        save_data_path=args.save_data_path, device=device,
        tensorboard=args.tensorboard, state=state,
        inception_state_dict=inception,
        allow_random_fid=args.allow_random_fid,
        fid_device_stats=args.fid_device_stats,
        compat_inference_indices=args.compat_inference_indices)

    if args.load_checkpoint:
        restore_checkpoint(args.load_checkpoint, trainer.state)
        print(f"Restored checkpoint {args.load_checkpoint} "
              f"(step {trainer.state.step})")
    if args.auto_resume:
        trainer.auto_resume(args.auto_resume)

    print("Number of generator parameters",
          param_count(trainer.state.generator))
    print("Number of discriminator parameters",
          param_count(trainer.state.discriminator))
    return trainer


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trainer = build_trainer(args)

    if args.train:
        trainer.train(epochs=args.epochs,
                      validate_after_n_iterations=args.validate_after_n_iterations,
                      save_model_after_n_epochs=args.save_model_after_n_epochs,
                      log_every=args.log_every)
    if args.test:
        print("FID=", trainer.validate())
        trainer.inference()
    return 0


if __name__ == "__main__":
    sys.exit(main())
