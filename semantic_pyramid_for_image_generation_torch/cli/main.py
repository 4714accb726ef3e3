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
  * `--multihost` trains one model on N processes, one device each, as
    torchrun launches them (data parallelism, parallel/mesh.py): nccl on
    `cuda` (cuda:LOCAL_RANK), gloo with `--device cpu`. The batch size is
    the global batch, rounded to a multiple of the world size, and each
    rank loads its rows of it. Every rank reads the weight files and
    checkpoints from its own disk, so all ranks must see the same files (a
    shared file system); ranks that end up holding different states raise:

        torchrun --nproc_per_node N -m \
            semantic_pyramid_for_image_generation_torch.cli.main \
            --multihost --train --path_to_places365 places365_standard

  * the perf modes run as in the JAX package: `--fused_d` (one D pass
    over real ++ fake in the D phase; implies the canonical projection,
    as `--canonical_projection` gives it), `--remat_vgg` (the VGG forward
    on the fakes recomputed in the backward) and `--remat_blocks` (G's and
    D's residual blocks recomputed in the backward);
  * `--fsdp K` (with `--multihost`) shards the training state as the JAX
    package's (data, fsdp) mesh does: the N ranks form an (N // K, K)
    mesh, and each leaf that the JAX package shards lives on its rank as
    1/K of itself, with its Adam moments (parallel/mesh.py::shard_state).
    K must divide N (else ValueError). Checkpoints are the same `.pt` at
    any K;
  * `--gpus_to_use` and `--use_data_parallel` are accepted and ignored, as
    in the JAX package;
  * `--arch biggan-deep-256` trains BigGAN-deep at 256x256 (config.py::
    BigGANDeepConfig, train/biggan_deep.py) instead of the Semantic Pyramid
    GAN, from a class-folder image tree (`--image_folder`, holding
    `train/<class>/*` and `val/<class>/*`, read by data/image_folder.py:
    [0, 1] pixels mapped to [-1, 1], integer labels in sorted class order).
    `--batch_size` is the rows of one D update, so a loader batch holds
    `num_d_steps` times as many; `--channel_factor` divides ch (128); the
    learning rates are the config's (`--lr` is the SP-GAN's). It trains on
    one process: `--multihost`, `--fsdp` and the perf modes raise:

        python -m semantic_pyramid_for_image_generation_torch.cli.main \
            --arch biggan-deep-256 --image_folder imagenet --train --test
"""

from __future__ import annotations

import argparse
import os
import sys


ARCHS = ("semantic-pyramid", "biggan-deep-256")


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
                   help="one D pass over real ++ fake in the D phase "
                        "(implies --canonical_projection)")
    p.add_argument("--remat_vgg", default=False, action="store_true",
                   help="rematerialize the VGG-fake forward in the G backward")
    p.add_argument("--remat_blocks", default=False, action="store_true",
                   help="rematerialize G/D residual blocks in the backward")
    p.add_argument("--compact_feed", default=False, action="store_true",
                   help="feed uint8 images/masks and normalize on device")
    p.add_argument("--tensorboard", default=False, action="store_true",
                   help="also stream metrics to TensorBoard under "
                        "<metrics dir>/tensorboard")
    p.add_argument("--multihost", default=False, action="store_true",
                   help="data-parallel training on the processes torchrun "
                        "launches (nccl on cuda, gloo on cpu)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="shard params + Adam moments over this many ranks "
                        "(a (data, fsdp) mesh; needs --multihost and must "
                        "divide the ranks)")
    # --- the models the port trains ---
    p.add_argument("--arch", type=str, default="semantic-pyramid",
                   choices=ARCHS,
                   help="the Semantic Pyramid GAN on Places365, or "
                        "BigGAN-deep 256x256 on --image_folder")
    p.add_argument("--image_folder", type=str, default=None,
                   help="biggan-deep-256: the root of train/<class>/* and "
                        "val/<class>/* images")
    return p


def check_supported(args) -> None:
    """Raise for flag values the port cannot run, the options that
    `--arch`'s family refuses first (train/family.py)."""
    from semantic_pyramid_for_image_generation_torch.train.family import (
        family_of,
    )

    family_of(config_from_args(args), multihost=args.multihost,
              fsdp=args.fsdp > 1, fused_discriminator=args.fused_d,
              remat_vgg=args.remat_vgg, remat_blocks=args.remat_blocks)
    if args.arch == "biggan-deep-256" and not args.image_folder:
        raise ValueError("--arch biggan-deep-256 reads its images from "
                         "--image_folder (train/<class>/*, val/<class>/*)")
    if args.fsdp > 1 and not args.multihost:
        raise ValueError(f"--fsdp {args.fsdp} shards the state over the "
                         "ranks of a --multihost launch (torchrun "
                         "--nproc_per_node N ... --multihost)")
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
    """The config of `--arch`, from the flags."""
    from semantic_pyramid_for_image_generation_torch import config

    if args.arch == "biggan-deep-256":
        return config.BigGANDeepConfig(ch=int(128 // args.channel_factor),
                                       compute_dtype=args.dtype)
    return config.PyramidGANConfig(
        channels_factor=args.channel_factor, compute_dtype=args.dtype,
        vgg_width_factor=args.vgg_width_factor,
        compat_projection=not (args.canonical_projection or args.fused_d),
        remat_blocks=args.remat_blocks)


class ClassFolderBatches:
    """An ImageFolderLoader's (images in [0, 1], labels) batches as the
    BigGAN-deep step takes them: {"images": 2 x - 1, "labels": int64}."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        import numpy as np

        for images, labels in self.loader:
            yield {"images": images * 2.0 - 1.0,
                   "labels": labels.astype(np.int64)}


def class_folder_inputs(args, config, device):
    """`--arch biggan-deep-256`'s loaders over `--image_folder`; the
    Trainer draws the state from the seed."""
    from semantic_pyramid_for_image_generation_torch.data.image_folder import (
        ImageFolder,
        ImageFolderLoader,
    )

    train, val = (ImageFolder(os.path.join(args.image_folder, split),
                              config.resolution, normalize=False)
                  for split in ("train", "val"))
    val.samples = val.samples[:args.fid_images]
    classes = max(len(train.class_to_idx), len(val.class_to_idx))
    if classes > config.num_classes:
        raise ValueError(f"{args.image_folder} holds {classes} classes; "
                         f"BigGAN-deep's embedding has {config.num_classes}")
    loader = lambda ds, rows, shuffle: ClassFolderBatches(  # noqa: E731
        ImageFolderLoader(ds, batch_size=rows, shuffle=shuffle,
                          random_flip=False, drop_last=shuffle,
                          num_workers=args.num_workers, seed=args.seed))
    return (loader(train, args.batch_size * config.num_d_steps, True),
            loader(val, 2 * args.batch_size, False), None, False)


def places365_inputs(args, config, device):
    """The SP-GAN's Places365 loaders (each rank decodes its rows of every
    global batch), and its state with the pretrained VGG where found."""
    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        rank,
        world_size,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
        vgg16_state_dict_from_torch,
    )

    state = init_train_state(config, device, lr=args.lr, seed=args.seed)
    found_vgg = bool(args.load_pretrained_vgg16
                     and os.path.exists(args.load_pretrained_vgg16))
    if found_vgg:
        state.vgg.load_state_dict(vgg16_state_dict_from_torch(
            load_torch_file(args.load_pretrained_vgg16)), strict=True)
        print(f"Loaded pretrained VGG16 from {args.load_pretrained_vgg16}")
    common = {"shuffle": True, "num_workers": args.num_workers,
              "compact_feed": args.compact_feed, "num_shards": world_size(),
              "shard_id": rank()}
    train = Places365Loader(
        Places365(args.path_to_places365, "train.txt", config),
        batch_size=args.batch_size, drop_last=True, **common)
    val = Places365Loader(
        Places365(args.path_to_places365, "val.txt", config,
                  max_length=args.fid_images, validation=True),
        batch_size=2 * args.batch_size, drop_last=False, **common)
    return train, val, state, found_vgg


def build_trainer(args):
    """Flags -> a fully wired Trainer (loaders, weight files, checkpoint
    restore): everything main() does before train() / validate(). The
    `--arch` values differ only in their config and `*_inputs`."""
    check_supported(args)
    from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
        check_fsdp,
        check_replicated,
        init_distributed,
        world_size,
    )
    from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
        restore_checkpoint,
    )
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer
    from semantic_pyramid_for_image_generation_torch.train.state import (
        param_count,
    )
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        resolve_device,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
    )

    if args.multihost:
        device = init_distributed(args.device.split(":")[0])
    else:
        device = resolve_device(args.device)
    world = world_size()
    check_fsdp(args.fsdp, world)
    if args.batch_size % world:
        rounded = max(world, (args.batch_size // world) * world)
        print(f"batch_size {args.batch_size} -> {rounded} (a multiple of the "
              f"{world} ranks)")
        args.batch_size = rounded
    config = config_from_args(args)
    inputs = (class_folder_inputs if args.arch == "biggan-deep-256"
              else places365_inputs)
    train_loader, val_loader, state, found_vgg = inputs(args, config, device)
    inception = None
    if args.load_inception and os.path.exists(args.load_inception):
        inception = load_torch_file(args.load_inception)

    trainer = Trainer(
        config, train_loader, val_loader,
        lr=args.lr, w_rec=args.w_rec, w_div=args.w_div, seed=args.seed,
        save_data_path=args.save_data_path, device=device,
        tensorboard=args.tensorboard, state=state,
        inception_state_dict=inception,
        allow_random_fid=args.allow_random_fid,
        fid_device_stats=args.fid_device_stats,
        compat_inference_indices=args.compat_inference_indices,
        remat_vgg=args.remat_vgg, fused_discriminator=args.fused_d,
        fsdp=args.fsdp)

    if args.load_checkpoint:
        restore_checkpoint(args.load_checkpoint, trainer.state)
        print(f"Restored checkpoint {args.load_checkpoint} "
              f"(step {trainer.state.step})")
    if args.auto_resume:
        trainer.auto_resume(args.auto_resume)
    check_replicated(trainer.state, vgg_file_found=found_vgg,
                     inception_file_found=inception is not None)

    for net in ("generator", "discriminator"):
        print(f"Number of {net} parameters",
              param_count(getattr(trainer.state, net)))
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
    if args.multihost:
        from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
            shutdown_distributed,
        )

        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
