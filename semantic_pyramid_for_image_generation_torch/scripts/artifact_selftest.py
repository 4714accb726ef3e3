"""Artifact-readiness selftest, counterpart of the repository's
scripts/artifact_selftest.py for the PyTorch port.

    python -m semantic_pyramid_for_image_generation_torch.scripts.artifact_selftest

The two north-star numbers (FID-10k on Places365 val and the VGG-16
fine-tune accuracies) need artifacts that are fetched, not built: the
torchvision Inception weights, the caffe Places365 VGG-16, the fine-tuned
VGG-16 and Places365 itself. This command checks which are present, runs
each evaluation they unlock through the port's production wiring
(cli/vgg16_finetune.py's build_model / make_eval_step / run_validation for
the accuracies, eval/fid.py's FIDEvaluator for the self-FID, cli/main.py's
build_trainer and Trainer.validate for the FID of G), compares each result
with its expectation and prints ONE JSON report as its last line:
{"ready", "missing"} with --check-only or when nothing is present, else
{"ready", "results", "checks", "passed"}. The exit code is 0 iff every
executed check passed (so 0, vacuously, when no evaluation could run).

Expected values (defaults; each is a flag, so a test can relax them):
  * VGG-16 Places365 top-1 / top-5 at 256, caffe weights before the
    fine-tune: 7.493% / 23.047% (+-0.5 point; the reference's README);
  * after the 3-epoch fine-tune (cli/vgg16_finetune.py, the reference's
    hyperparameters): 51.140% / 82.085% (+-1.0 point; the reference's own
    result, and data order is random, so agreement is to the point);
  * self-FID (Places365 val against itself, a 2 x 5k split, standard
    Inception weights): < 2.0 (a sound pipeline gives ~0-1; a resize or
    normalization fault inflates it by orders of magnitude);
  * FID of an untrained generator against Places365 val: 300-500 (a sanity
    band: the reference published no FID; a trained checkpoint given with
    --load_checkpoint reports its own number, unchecked).

The port fetches nothing: the `fetch` hints name the JAX repository's
download scripts and the port's fine-tune. Weights are read by the port's
own means (utils/pt_interop.py). Every evaluation runs on `--device`
(default cuda, which raises without a card); presence is checked, and
--check-only answered, without a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FETCH = {
    "inception": "bash scripts/download_inception.sh",
    "vgg_caffe": "bash scripts/download_pretrained_vgg16.sh",
    "vgg_finetuned": "python -m semantic_pyramid_for_image_generation_torch"
                     ".cli.vgg16_finetune --data places365_standard "
                     "--load_vgg16 pre_trained_models/vgg_places_365_raw.pt "
                     "--export_pt "
                     "pre_trained_models/vgg_places_365_fine_tuned.pt",
    "places365": "bash scripts/download_places365.sh",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="artifact-readiness selftest (see module docstring)")
    p.add_argument("--check-only", action="store_true",
                   help="report artifact presence and exit")
    p.add_argument("--load_checkpoint", type=str, default=None,
                   help="trained reference-layout .pt checkpoint for the FID "
                        "record run")
    # artifact locations (flags, so a test can point at stand-ins)
    p.add_argument("--inception_pt",
                   default="pre_trained_models/inception_v3_google.pth")
    p.add_argument("--vgg_pt",
                   default="pre_trained_models/vgg_places_365_raw.pt")
    p.add_argument("--vgg_finetuned_pt",
                   default="pre_trained_models/vgg_places_365_fine_tuned.pt")
    p.add_argument("--places", default="places365_standard")
    # scale (production defaults; a test shrinks them)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--fid_images", type=int, default=10_000)
    p.add_argument("--self_fid_images", type=int, default=5_000,
                   help="images PER HALF of the real-vs-real split (2 x 5k "
                        "by default, the calibration in the module "
                        "docstring)")
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--channel_factor", type=float, default=1.0)
    p.add_argument("--vgg_width_factor", type=int, default=1)
    p.add_argument("--scan_group", type=int, default=16,
                   help="accepted for the JAX script's command lines and "
                        "ignored: the port walks the validation batches one "
                        "by one (it has no fid_scan)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (cuda raises without a card)")
    # expectations
    p.add_argument("--expect_top1_before", type=float, nargs=2,
                   default=(7.493, 0.5), metavar=("VALUE", "TOL"))
    p.add_argument("--expect_top5_before", type=float, nargs=2,
                   default=(23.047, 0.5), metavar=("VALUE", "TOL"))
    p.add_argument("--expect_top1_after", type=float, nargs=2,
                   default=(51.140, 1.0), metavar=("VALUE", "TOL"))
    p.add_argument("--expect_top5_after", type=float, nargs=2,
                   default=(82.085, 1.0), metavar=("VALUE", "TOL"))
    p.add_argument("--expect_self_fid_max", type=float, default=2.0)
    p.add_argument("--expect_fid_band", type=float, nargs=2,
                   default=(300.0, 500.0), metavar=("LO", "HI"))
    return p


def check_artifacts(args) -> Dict[str, bool]:
    present = {
        "inception": os.path.exists(args.inception_pt),
        "vgg_caffe": os.path.exists(args.vgg_pt),
        "vgg_finetuned": os.path.exists(args.vgg_finetuned_pt),
        "places365": os.path.isdir(os.path.join(args.places, "val")),
    }
    for name, ok in present.items():
        print(f"  [{'ok' if ok else 'MISSING'}] {name}"
              + ("" if ok else f"  -> {FETCH[name]}"))
    return present


def _require(path: str) -> None:
    """A direct call without its artifact raises: nothing here falls back
    to random weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"artifact {path} is missing")


def run_vgg_accuracy(args, weights: str) -> Tuple[float, float]:
    """Top-1 / top-5 (percent) at 256 over Places365 val through the
    fine-tune CLI's eval step and validation walk."""
    from semantic_pyramid_for_image_generation_torch.cli.vgg16_finetune import (
        build_model,
        make_eval_step,
        run_validation,
    )
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

    _require(weights)
    device = resolve_device(args.device)
    cfg = PyramidGANConfig(vgg_width_factor=args.vgg_width_factor)
    model = build_model(cfg, device, weights)
    loader = ImageFolderLoader(
        ImageFolder(os.path.join(args.places, "val"), cfg.image_size),
        args.batch_size, shuffle=False, random_flip=False, drop_last=False,
        num_workers=args.num_workers)
    _, top1, top5 = run_validation(make_eval_step(model), loader, device)
    return 100.0 * top1, 100.0 * top5


def run_self_fid(args) -> float:
    """Real-vs-real FID over a 2-way split of Places365 val (alternate
    batches of min(50, batch_size) images to alternate halves): the whole
    activation pipeline, no generator."""
    import numpy as np
    import torch

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.eval.fid import (
        FIDEvaluator,
        fid_from_activations,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        load_torch_file,
    )

    _require(args.inception_pt)
    evaluator = FIDEvaluator(load_torch_file(args.inception_pt), args.device)
    dataset = Places365(args.places, "val.txt", PyramidGANConfig(),
                        max_length=2 * args.self_fid_images, validation=True)
    loader = Places365Loader(dataset, batch_size=min(50, args.batch_size),
                             shuffle=False, drop_last=True,
                             num_workers=args.num_workers)
    halves: list = [[], []]
    for i, batch in enumerate(loader):
        halves[i % 2].append(evaluator.activations(
            torch.from_numpy(batch["images"])).cpu().numpy())
    if not halves[1]:
        raise ValueError(
            f"the self-FID needs two batches of {min(50, args.batch_size)} "
            f"validation images; {len(dataset)} were read")
    fid = fid_from_activations(np.concatenate(halves[0]),
                               np.concatenate(halves[1]))
    print(f"self-FID (real vs real 2-way split): {fid:.3f} "
          f"(expect < {args.expect_self_fid_max})")
    return fid


def run_fid(args) -> float:
    """Generator-vs-val FID through the Trainer that `cli/main.py --test`
    builds (build_trainer), batch by batch."""
    from semantic_pyramid_for_image_generation_torch.cli import main as cli_main

    _require(args.inception_pt)
    argv = ["--test", "--path_to_places365", args.places,
            "--fid_images", str(args.fid_images),
            "--batch_size", str(args.batch_size),
            "--num_workers", str(args.num_workers),
            "--channel_factor", str(args.channel_factor),
            "--vgg_width_factor", str(args.vgg_width_factor),
            "--load_inception", args.inception_pt,
            "--load_pretrained_vgg16", args.vgg_finetuned_pt,
            "--device", args.device]
    if args.load_checkpoint:
        argv += ["--load_checkpoint", args.load_checkpoint]
    trainer = cli_main.build_trainer(cli_main.build_parser().parse_args(argv))
    return trainer.validate()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if argv is None:  # run as a command: artifact paths are repo-relative
        os.chdir(REPO)
    print("artifact presence:")
    present = check_artifacts(args)
    if args.check_only or not any(present.values()):
        missing = [k for k, v in present.items() if not v]
        print(json.dumps({"ready": not missing, "missing": missing}))
        return 0 if not missing else 1

    results: dict = {}
    checks: dict = {}

    def band(name, value, want, tol):
        results[name] = round(float(value), 4)
        checks[name] = bool(abs(float(value) - want) <= tol)
        print(f"  {name}: {value:.3f} (expect {want}+-{tol}) "
              f"-> {'ok' if checks[name] else 'FAIL'}")

    if present["places365"]:
        # every evaluation reads Places365: without a card this raises
        # unless --device cpu was asked for
        from semantic_pyramid_for_image_generation_torch.utils.device import (
            resolve_device,
        )

        resolve_device(args.device)
    if present["places365"] and present["vgg_caffe"]:
        print("-- VGG accuracy @256, caffe weights (before fine-tune)")
        t1, t5 = run_vgg_accuracy(args, args.vgg_pt)
        band("vgg_top1_before", t1, *args.expect_top1_before)
        band("vgg_top5_before", t5, *args.expect_top5_before)
    if present["places365"] and present["vgg_finetuned"]:
        print("-- VGG accuracy @256, fine-tuned weights")
        t1, t5 = run_vgg_accuracy(args, args.vgg_finetuned_pt)
        band("vgg_top1_after", t1, *args.expect_top1_after)
        band("vgg_top5_after", t5, *args.expect_top5_after)
    if present["places365"] and present["inception"]:
        fid = run_self_fid(args)
        results["self_fid"] = round(float(fid), 4)
        checks["self_fid"] = bool(fid < args.expect_self_fid_max)
    if present["places365"] and present["vgg_finetuned"] \
            and present["inception"]:
        # without the standard backbone the FID is a random-feature number
        # the band says nothing about, so the Inception file gates it too
        lo, hi = args.expect_fid_band
        which = ("checkpoint " + args.load_checkpoint
                 if args.load_checkpoint else "untrained G")
        print(f"-- FID-{args.fid_images} ({which}; untrained sanity band "
              f"{lo}-{hi})")
        fid = run_fid(args)
        results["fid"] = round(float(fid), 4)
        # the band gates only the untrained G; a checkpoint's FID is the
        # record itself
        checks["fid_band"] = bool(lo <= fid <= hi) \
            if not args.load_checkpoint else True

    if not checks:
        print("no evaluation unlocked by the present artifacts "
              "(see MISSING lines above)")
    passed = all(checks.values())
    print(json.dumps({"ready": all(present.values()), "results": results,
                      "checks": checks, "passed": passed}))
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
