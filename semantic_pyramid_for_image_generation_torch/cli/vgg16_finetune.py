"""VGG-16 Places365 fine-tune: cross-entropy and Adam on an ImageFolder tree,
with Prec@1 / Prec@5 validation, `latest` / `best` checkpoints, a lossless
`--resume` and a reference-loadable `--export_pt`.

    python -m semantic_pyramid_for_image_generation_torch.cli.vgg16_finetune \
        --data places365_standard --epochs 3 --batch_size 256

Counterpart of the JAX package's cli/vgg16_finetune.py, with the same flags
except `--device`, which defaults to `cuda` and raises without a card (pass
`--device cpu` to run on the CPU). One step is the VGG16 forward in training
mode (dropout after ReLU(fc6) and ReLU(fc7); the five max pools run Kernel
2 forward and Kernel 4 backward on the card), float32 cross-entropy on the
logits, and one Adam update (b1 0.9, b2 0.999, eps 1e-8, as optax.adam).
The learning rate decays tenfold every 30 epochs (`epoch_lr_scale`), set on
the optimizer at the start of each epoch: the JAX package scales Adam's
updates by the same factor, the same update up to rounding.

Checkpoints are `.pt` files, `<save_dir>/latest_<epoch>.pt` after every
epoch and `<save_dir>/best.pt` when Prec@1 improved, each holding everything
a lossless restart needs: {"epoch": the next epoch, "state_dict": the VGG16
state dict (`vgg16.*` keys), "optimizer": the torch Adam state dict,
"best_prec1"}, the fields the reference's resume reads. The training data
order is keyed on (seed, epoch) and each step's dropout masks on (epoch,
step), so `--resume` replays what an uninterrupted run would have done.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np

INIT_SEED = 0  # a cold start's random init (the JAX CLI's key(0))
DROPOUT_SEED = 1  # the dropout streams (the JAX CLI's key(1))
LOG_EVERY = 50  # steps between the metric fetches of the log line
_LATEST = re.compile(r"latest_(\d+)\.pt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="VGG16 Places365 fine-tune (PyTorch + CUDA)")
    p.add_argument("--data", type=str, default="places365_standard")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--resume", type=str, default=None,
                   help="resume a fine-tune losslessly: a checkpoint file "
                        "(latest_N.pt / best.pt) or a save_dir (picks the "
                        "newest latest_N.pt). Restores the weights, the Adam "
                        "state, the epoch and best_prec1")
    p.add_argument("--load_vgg16", type=str,
                   default="pre_trained_models/vgg_places_365.pt",
                   help=".pt start point (caffe2pytorchvgg16 output)")
    p.add_argument("--save_dir", type=str, default="vgg16_finetune")
    p.add_argument("--export_pt", type=str, default=None,
                   help="also write the best weights as a reference-loadable "
                        ".pt state dict (vgg16.* keys, the reference's "
                        "vgg_places_365_fine_tuned.pt)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--evaluate_only", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    p.add_argument("--vgg_width_factor", type=int, default=1,
                   help="debug: divide VGG widths (CPU-scale smoke runs)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=365)
    p.add_argument("--max_steps", type=int, default=None,
                   help="debug: cap train steps per epoch")
    return p


def epoch_lr_scale(epoch: int) -> float:
    """Step decay /10 every 30 epochs (the reference's adjust_learning_rate)."""
    return 0.1 ** (epoch // 30)


def set_epoch_lr(optimizer, lr: float, epoch: int) -> None:
    """Adam at lr * epoch_lr_scale(epoch) for this epoch's steps."""
    for group in optimizer.param_groups:
        group["lr"] = lr * epoch_lr_scale(epoch)


def resolve_resume_path(path: str) -> Optional[str]:
    """Map --resume to one checkpoint file: a file as it is, or in a
    save_dir the numerically newest `latest_<N>.pt`. None when nothing is
    there."""
    if os.path.isfile(path):
        return os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    latest = [(int(m.group(1)), e) for e in os.listdir(path)
              if (m := _LATEST.fullmatch(e))]
    if not latest:
        return None
    return os.path.abspath(os.path.join(path, max(latest)[1]))


def export_state_dict(model) -> dict:
    """The VGG16 state dict (`vgg16.*` keys) as CPU copies: what
    `--export_pt` writes and a reference VGG16 loads with strict=True."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def save_finetune_checkpoint(path: str, model, optimizer, epoch_next: int,
                             best_prec1: float) -> None:
    """One `.pt` file: the next epoch (the reference saves epoch + 1 and
    resumes there), the weights, the Adam state and the best Prec@1."""
    import torch

    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        adam_state_dict_in_module_order,
    )

    torch.save({"epoch": int(epoch_next),
                "state_dict": export_state_dict(model),
                "optimizer": adam_state_dict_in_module_order(optimizer, model),
                "best_prec1": float(best_prec1)}, path)


def restore_finetune_checkpoint(path: str, model, optimizer
                                ) -> Tuple[int, float]:
    """Load a checkpoint into the live model and optimizer; returns
    (start_epoch, best_prec1)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["epoch"]), float(ckpt["best_prec1"])


def make_optimizer(model, lr: float):
    import torch

    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def dropout_generator(epoch: int, step: int, device):
    """The dropout generator of one train step, seeded by (epoch, step)."""
    import torch

    words = np.random.SeedSequence((DROPOUT_SEED, epoch, step)).generate_state(
        2, np.uint32)
    return torch.Generator(device).manual_seed(
        int(words[0]) << 32 | int(words[1]))


def batch_to_device(images: np.ndarray, labels: np.ndarray, device):
    """A loader batch -> (images (B, 3, H, W), the NCHW view of the NHWC
    batch; labels (B,) int64) on `device`."""
    import torch

    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    y = torch.from_numpy(np.asarray(labels)).to(device, torch.int64)
    return x.permute(0, 3, 1, 2), y


def make_finetune_step(model, optimizer):
    """The fine-tune update: `(images, labels, rng=None, dropout_masks=None)
    -> (loss, top1)`, 0-d float32 tensors on the device, left there. The
    forward runs in training mode with dropout masks drawn from `rng` or
    pinned as `dropout_masks` (two boolean (B, fc) tensors); the loss is the
    mean float32 cross-entropy of the logits; one Adam step at the
    optimizer's current lr; top1 is the training logits' accuracy."""
    import torch
    import torch.nn.functional as F

    from semantic_pyramid_for_image_generation_torch.utils.device import (
        exact_float32,
    )

    def train_step(images, labels, rng=None,
                   dropout_masks: Optional[Sequence] = None):
        model.train()
        with exact_float32():
            logits = model(images, dropout_rng=rng, dropout_masks=dropout_masks)
            loss = F.cross_entropy(logits.float(), labels)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        top1 = (logits.detach().argmax(-1) == labels).to(torch.float32).mean()
        return loss.detach(), top1

    return train_step


def make_eval_step(model):
    """Per-sample eval metrics of one batch: `(images, labels) -> (ce, top1,
    top5)`, (B,) float32 tensors: the float32 cross-entropy of the
    eval-mode logits, and whether the label is the argmax / among the top
    min(5, classes) logits."""
    import torch
    import torch.nn.functional as F

    from semantic_pyramid_for_image_generation_torch.utils.device import (
        exact_float32,
    )

    def eval_step(images, labels):
        model.eval()
        with torch.inference_mode(), exact_float32():
            logits = model(images)
            ce = F.cross_entropy(logits.float(), labels, reduction="none")
            top1 = (logits.argmax(-1) == labels).to(torch.float32)
            k = min(5, logits.shape[-1])
            top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(
                -1).to(torch.float32)
        return ce, top1, top5

    return eval_step


def run_validation(eval_step, loader, device) -> Tuple[float, float, float]:
    """The reference's validate() walk over an ImageFolderLoader, every
    batch (the remainder too). Returns (ce_loss, prec1, prec5) as fractions;
    the sums stay on the device and are fetched once."""
    import torch

    sums = torch.zeros(3, dtype=torch.float64, device=device)
    count = 0
    for images, labels in loader:
        x, y = batch_to_device(images, labels, device)
        ce, top1, top5 = eval_step(x, y)
        sums += torch.stack([ce.sum(), top1.sum(), top5.sum()]).double()
        count += len(labels)
    loss, prec1, prec5 = (sums / max(count, 1)).tolist()
    print(f" * Prec@1 {prec1 * 100:.3f} Prec@5 {prec5 * 100:.3f}")
    return loss, prec1, prec5


def build_model(config, device, load_vgg16: Optional[str]):
    """A VGG16 classifier (`return_output=True`) on `device` in
    channels_last: from a `.pt` (reference, torchvision or caffe keys, or a
    whole-module pickle) when the file exists, else a random init from
    INIT_SEED."""
    import torch

    from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
        vgg16_state_dict_from_torch,
    )

    with torch.device(device):
        model = VGG16(config, return_output=True)
    if load_vgg16 and os.path.exists(load_vgg16):
        model.load_state_dict(vgg16_state_dict_from_torch(
            load_torch_file(load_vgg16)), strict=True)
        print(f"Loaded {load_vgg16}")
    else:
        model.initialize(torch.Generator(device).manual_seed(INIT_SEED))
        print("Cold start: random VGG16 init")
    return model.to(memory_format=torch.channels_last)


class FineTune:
    """Everything main() wires from the flags: model, optimizer, steps,
    loaders, and the epoch and best Prec@1 to start from."""

    def __init__(self, args):
        from semantic_pyramid_for_image_generation_torch.config import (
            PyramidGANConfig,
        )
        from semantic_pyramid_for_image_generation_torch.data.image_folder import (
            ImageFolder,
            ImageFolderLoader,
        )
        from semantic_pyramid_for_image_generation_torch.utils.device import (
            resolve_device,
        )

        self.args = args
        self.device = resolve_device(args.device)
        self.config = PyramidGANConfig(
            compute_dtype=args.dtype, vgg_width_factor=args.vgg_width_factor,
            image_size=args.image_size, num_classes=args.num_classes)
        self.model = build_model(self.config, self.device, args.load_vgg16)
        self.optimizer = make_optimizer(self.model, args.lr)
        self.start_epoch, self.best_prec1 = 0, 0.0
        if args.resume:
            path = resolve_resume_path(args.resume)
            if path is None:
                print(f"=> no checkpoint found at '{args.resume}'")
            else:
                print(f"=> loading checkpoint '{path}'")
                self.start_epoch, self.best_prec1 = restore_finetune_checkpoint(
                    path, self.model, self.optimizer)
                print(f"=> loaded checkpoint '{path}' (epoch "
                      f"{self.start_epoch}, best_prec1 {self.best_prec1:.3f})")
        self.train_step = make_finetune_step(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        size = self.config.image_size
        self.train_loader = ImageFolderLoader(
            ImageFolder(os.path.join(args.data, "train"), size),
            args.batch_size, num_workers=args.workers)
        # a resumed run sees epoch N's shuffle order, as an uninterrupted
        # run would: the loader keys its order on (seed, epoch)
        self.train_loader.epoch = self.start_epoch
        self.val_loader = ImageFolderLoader(
            ImageFolder(os.path.join(args.data, "val"), size),
            args.batch_size, shuffle=False, random_flip=False,
            drop_last=False, num_workers=args.workers)

    def validate(self) -> float:
        return run_validation(self.eval_step, self.val_loader, self.device)[1]

    def train_epoch(self, epoch: int) -> None:
        """One epoch of steps; the loss and top-1 sums stay on the device
        and are fetched for the log line every LOG_EVERY steps."""
        import torch

        args = self.args
        set_epoch_lr(self.optimizer, args.lr, epoch)
        sums = torch.zeros(2, device=self.device)
        count = 0
        t0 = time.time()
        for it, (images, labels) in enumerate(self.train_loader):
            if args.max_steps is not None and it >= args.max_steps:
                break
            x, y = batch_to_device(images, labels, self.device)
            loss, top1 = self.train_step(
                x, y, dropout_generator(epoch, it, self.device))
            sums += torch.stack([loss, top1]) * len(labels)
            count += len(labels)
            if it % LOG_EVERY == 0:
                loss_avg, top1_avg = (sums / count).tolist()
                rate = (it + 1) * args.batch_size / (time.time() - t0)
                print(f"epoch {epoch} it {it} loss {loss_avg:.4f} "
                      f"top1 {top1_avg * 100:.2f} ({rate:.1f} img/s)")

    def run(self) -> None:
        """Train from start_epoch to --epochs, validating and checkpointing
        after each epoch; with --evaluate_only, validate once."""
        import torch

        args = self.args
        if args.evaluate_only:
            self.validate()
            return
        os.makedirs(args.save_dir, exist_ok=True)
        for epoch in range(self.start_epoch, args.epochs):
            self.train_epoch(epoch)
            prec1 = self.validate()
            is_best = prec1 > self.best_prec1
            self.best_prec1 = max(prec1, self.best_prec1)
            save_finetune_checkpoint(
                os.path.join(args.save_dir, f"latest_{epoch}.pt"),
                self.model, self.optimizer, epoch + 1, self.best_prec1)
            if is_best:
                save_finetune_checkpoint(
                    os.path.join(args.save_dir, "best.pt"),
                    self.model, self.optimizer, epoch + 1, self.best_prec1)
                if args.export_pt:
                    if args.vgg_width_factor != 1:
                        raise SystemExit(
                            "--export_pt needs full-width VGG16 "
                            "(--vgg_width_factor 1): the reference loads "
                            "torchvision shapes")
                    torch.save(export_state_dict(self.model), args.export_pt)
                    print(f"exported reference-loadable {args.export_pt}")


def main(argv=None) -> int:
    FineTune(build_parser().parse_args(argv)).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
