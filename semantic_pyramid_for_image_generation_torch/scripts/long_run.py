"""Long-horizon training run on the card, counterpart of the repository's
scripts/long_run.py for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.long_run \
        [--steps 2048] [--batch 64] [--classes 16] \
        [--validate_every_steps 512] [--out saved_data/torch_longrun]

~2k bf16 steps at batch 64 on a synthetic Places365-format JPEG tree
(scripts/jpeg_tree.py: `--classes` x 1,024 training and x 16 validation
JPEGs), through the production path: cli/main.py -> Trainer.train with 16
loader threads, the compact (uint8) feed normalized on the card, a
validation (FID with a random-init Inception) every
`--validate_every_steps` steps and at the start, and per-epoch grids and
checkpoints under `--save_dir`, which it empties first. The tree is built
under `--data_dir` unless it holds one of that size; one of another size
is refused. By default the tree goes to the temporary directory (it
follows TMPDIR), named after its size, and `--save_dir` is `--out`/save.
Afterwards it writes to `--out`: loss_curves.png (four panels drawn with
PIL.ImageDraw), the first, middle and last sweep grids, and summary.json,
which it also prints: steps, samples, wall seconds, end-to-end images/s,
the semantic-reconstruction loss's first and last 100-step means, the FID
trajectory, whether every curve stayed finite, the grids kept, and the
card (`nvidia-smi` name and power limit; "cpu" with --device cpu).

`kill -USR1 <pid>` dumps every thread's stack to stderr, so a stall (a
validation's host sqrtm, a loader thread) shows where it stands.

The parts are functions (`epochs_for`, `with_dirs`, `ensure_tree`,
`train_argv`, `collect_curves`, `plot_curves`, `keep_grids`, `summarize`,
`run`), so a test can drive them at tiny widths through `run`'s
`extra_cli_args`.
"""

from __future__ import annotations

import argparse
import faulthandler
import glob
import json
import os
import shutil
import signal
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np

from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
    make_jpeg_tree,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    resolve_device,
)

PER_CLASS = 1024  # training JPEGs per class: the run is a handful of epochs
VAL_PER_CLASS = 16
CURVES = ("loss_generator", "loss_discriminator_real",
          "loss_discriminator_fake", "loss_generator_semantic_reconstruction",
          "loss_generator_diversity", "iterations", "fid", "iterations_fid")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="long-horizon training run")
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--validate_every_steps", type=int, default=512)
    p.add_argument("--data_dir", type=str, default=None,
                   help="the JPEG tree (default: torch_longrun_data_"
                        "<classes>x1024 in the temporary directory)")
    p.add_argument("--save_dir", type=str, default=None,
                   help="the run's directory, emptied first (default: "
                        "<out>/save)")
    p.add_argument("--out", type=str, default="saved_data/torch_longrun")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    return p


def epochs_for(steps: int, classes: int, batch: int,
               per_class: int = PER_CLASS) -> int:
    """Epochs of `classes * per_class` images that cover `steps` steps."""
    steps_per_epoch = classes * per_class // batch
    return -(-steps // steps_per_epoch)


def with_dirs(args: argparse.Namespace,
              per_class: int = PER_CLASS) -> argparse.Namespace:
    """`args` with the default --data_dir and --save_dir filled in: the
    tree in the temporary directory, named after its size, and the run
    under --out."""
    return argparse.Namespace(**{
        **vars(args),
        "data_dir": args.data_dir or os.path.join(
            tempfile.gettempdir(),
            f"torch_longrun_data_{args.classes}x{per_class}"),
        "save_dir": args.save_dir or os.path.join(args.out, "save")})


def ensure_tree(data_dir: str, classes: int, per_class: int) -> None:
    """Build the tree under `data_dir` unless it holds one; raise
    ValueError if the one it holds has another size."""
    want = {"train.txt": classes * per_class,
            "val.txt": classes * VAL_PER_CLASS}
    paths = {name: os.path.join(data_dir, name) for name in want}
    if not any(os.path.exists(p) for p in paths.values()):
        print(f"building {classes}x{per_class} JPEG tree...", flush=True)
        make_jpeg_tree(data_dir, per_class=per_class, classes=classes,
                       val_per_class=VAL_PER_CLASS)
        return
    for name, n in want.items():
        lines = 0
        if os.path.exists(paths[name]):
            with open(paths[name]) as f:
                lines = sum(1 for ln in f if ln.strip())
        if lines != n:
            raise ValueError(
                f"{paths[name]} lists {lines} images, not the {n} of a "
                f"{classes}x{per_class} tree; remove {data_dir} or pass "
                "another --data_dir")


def train_argv(args: argparse.Namespace, epochs: int) -> List[str]:
    """cli/main.py's argv: the JAX script's, then `--device`."""
    return [
        "--train", "--batch_size", str(args.batch), "--epochs", str(epochs),
        "--path_to_places365", args.data_dir,
        "--fid_images", str(args.classes * VAL_PER_CLASS),
        "--validate_after_n_iterations",
        str(args.validate_every_steps * args.batch),
        "--num_workers", "16", "--compact_feed", "--allow_random_fid",
        "--save_data_path", args.save_dir, "--log_every", "50",
        "--save_model_after_n_epochs", str(max(1, epochs // 2)),
        "--dtype", "bfloat16", "--lr", "1e-4", "--seed", "0",
        "--device", args.device,
    ]


def _newest(save_dir: str, kind: str) -> str:
    return sorted(glob.glob(os.path.join(save_dir, f"{kind}_*")))[-1]


def collect_curves(save_dir: str) -> Dict[str, np.ndarray]:
    """The run's metric arrays (the newest metrics_* directory)."""
    metrics_dir = _newest(save_dir, "metrics")
    curves = {}
    for name in CURVES:
        path = os.path.join(metrics_dir, f"{name}.npy")
        if os.path.exists(path):
            curves[name] = np.load(path)
    return curves


def _panel(draw, box, series, title: str, marker: bool = False) -> None:
    """One line plot in `box` (left, top, right, bottom): each (xs, ys) of
    `series` scaled to the finite values' range, a frame, the title and the
    x label."""
    left, top, right, bottom = box
    x0, y0, x1, y1 = left + 60, top + 28, right - 12, bottom - 34
    draw.rectangle((x0, y0, x1, y1), outline="black")
    draw.text((x0, top + 8), title, fill="black")
    draw.text(((x0 + x1) // 2 - 36, bottom - 22), "samples seen",
              fill="black")
    finite = [(np.asarray(xs, np.float64), np.asarray(ys, np.float64))
              for xs, ys in series]
    finite = [(xs[m], ys[m]) for xs, ys in finite
              for m in [np.isfinite(xs) & np.isfinite(ys)] if m.any()]
    if not finite:
        return
    xs_all = np.concatenate([xs for xs, _ in finite])
    ys_all = np.concatenate([ys for _, ys in finite])
    xlo, xhi = xs_all.min(), max(xs_all.max(), xs_all.min() + 1e-12)
    ylo, yhi = ys_all.min(), max(ys_all.max(), ys_all.min() + 1e-12)
    for value, y in ((yhi, y0), (ylo, y1)):
        draw.text((left + 4, y - 6), f"{value:.3g}", fill="black")
    for value, x in ((xlo, x0), (xhi, x1 - 40)):
        draw.text((x, y1 + 4), f"{value:.0f}", fill="black")
    for xs, ys in finite:
        px = x0 + (xs - xlo) / (xhi - xlo) * (x1 - x0)
        py = y1 - (ys - ylo) / (yhi - ylo) * (y1 - y0)
        points = list(zip(px.tolist(), py.tolist()))
        if len(points) > 1:
            draw.line(points, fill=(31, 119, 180), width=1)
        if marker or len(points) == 1:
            for x, y in points:
                draw.ellipse((x - 3, y - 3, x + 3, y + 3), fill=(31, 119, 180))


def plot_curves(curves: Dict[str, np.ndarray], out: str) -> str:
    """`out`/loss_curves.png: the JAX script's four panels (G loss, D loss
    real + fake, the semantic reconstruction loss, the FID trajectory)
    against samples seen, drawn with PIL.ImageDraw."""
    from PIL import Image, ImageDraw

    width, height = 1210, 770
    image = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(image)
    it = curves["iterations"]
    panels = [
        ([(it, curves["loss_generator"])], "LSGAN generator loss", False),
        ([(it, curves["loss_discriminator_real"]
           + curves["loss_discriminator_fake"])],
         "LSGAN discriminator loss (real+fake)", False),
        ([(it, curves["loss_generator_semantic_reconstruction"])],
         "semantic reconstruction loss (w_rec applied)", False),
    ]
    if "fid" in curves and len(curves["fid"]):
        panels.append(([(curves["iterations_fid"], curves["fid"])],
                       "pipeline-FID (random-backbone smoke metric)", True))
    for k, (series, title, marker) in enumerate(panels):
        col, row = k % 2, k // 2
        box = (col * width // 2, row * height // 2, (col + 1) * width // 2,
               (row + 1) * height // 2)
        _panel(draw, box, series, title, marker)
    path = os.path.join(out, "loss_curves.png")
    image.save(path)
    return path


def keep_grids(save_dir: str, out: str) -> List[str]:
    """Copy the first, middle and last sweep grids (all, if fewer than 3) of
    the newest plots_* directory to `out`; their paths there."""
    grids = sorted(glob.glob(os.path.join(_newest(save_dir, "plots"),
                                          "predictions_*.png")),
                   key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    keep = [grids[0], grids[len(grids) // 2], grids[-1]] \
        if len(grids) >= 3 else grids
    kept = []
    for g in keep:
        kept.append(os.path.join(out, os.path.basename(g)))
        shutil.copy(g, kept[-1])
    return kept


def summarize(curves: Dict[str, np.ndarray], wall: float,
              kept: Sequence[str], card: str) -> Dict:
    """The JAX script's summary, plus the card it ran on."""
    it = curves["iterations"]
    rec = curves["loss_generator_semantic_reconstruction"]
    return {
        "steps": int(len(it)),
        "samples": int(it[-1]) if len(it) else 0,
        "wall_s": round(wall, 1),
        "img_per_sec_end_to_end": round(float(it[-1]) / wall, 1),
        "loss_rec_first_100_mean": float(np.mean(rec[:100])),
        "loss_rec_last_100_mean": float(np.mean(rec[-100:])),
        "fid_trajectory": [round(float(f), 2) for f in curves.get("fid", [])],
        "fid_iterations": [int(i) for i in curves.get("iterations_fid", [])],
        "all_finite": bool(all(np.isfinite(v).all()
                               for v in curves.values())),
        "grids_kept": [os.path.basename(g) for g in kept],
        "card": card,
    }


def run(args: argparse.Namespace, per_class: int = PER_CLASS,
        extra_cli_args: Sequence[str] = ()) -> Dict:
    """Fill in the default directories (`with_dirs`), build the tree
    (`ensure_tree`), train through cli/main.py with `train_argv` +
    `extra_cli_args`, then write the curves, the kept grids
    and summary.json to `args.out`; returns the summary."""
    from semantic_pyramid_for_image_generation_torch.cli import main as cli_main

    device = resolve_device(args.device)
    args = with_dirs(args, per_class)
    ensure_tree(args.data_dir, args.classes, per_class)
    epochs = epochs_for(args.steps, args.classes, args.batch, per_class)
    shutil.rmtree(args.save_dir, ignore_errors=True)

    start = time.perf_counter()
    cli_main.main(train_argv(args, epochs) + list(extra_cli_args))
    wall = time.perf_counter() - start

    os.makedirs(args.out, exist_ok=True)
    curves = collect_curves(args.save_dir)
    plot_curves(curves, args.out)
    kept = keep_grids(args.save_dir, args.out)
    summary = summarize(curves, wall, kept,
                        card_line() if device.type == "cuda" else "cpu")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> int:
    import PIL.ImageDraw  # noqa: F401  (the plotter: fail now, not after the run)

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
