"""The training CLI with sharded state: `--multihost --fsdp 2` on two gloo
ranks on the CPU (each told its rank as torchrun tells it), on a mini
Places365 tree (tests/test_torch_cli.py's).

  * Training and testing: one run directory, written by rank 0 alone, with
    `checkpoint_000.pt` in the reference layout (whole tensors: every rank
    gathers, rank 0 writes), the metrics (every step logged once) and the
    grids; both ranks print the same FID. The validation set has 5 images
    in batches of 4, so its last batch leaves rank 1 no row: that rank
    generates a padded row it does not count, and nothing waits.
  * A rerun with `--test --auto_resume` at `--fsdp 2` restores the
    checkpoint on both ranks (step 2) and prints one FID on both.
  * One process without `--multihost` restores the same file with
    `--load_checkpoint`.
"""

import glob
import os
import re

import numpy as np
import torch
from PIL import Image

from semantic_pyramid_for_image_generation_torch.cli import main as cli
from torch_parallel_rank import join, start

CLI = ["-m", "semantic_pyramid_for_image_generation_torch.cli.main"]


def _places(root):
    """2 training classes x 2 images; 5 validation images."""
    rng = np.random.default_rng(0)
    for split, per_class in (("train", (2, 2)), ("val", (3, 2))):
        lines = []
        for cls, n in zip(("abbey", "zoo"), per_class):
            (root / split / cls).mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (256, 256, 3),
                                             dtype=np.uint8)).save(
                    root / split / cls / f"{i}.jpg")
                lines.append(f"{split}/{cls}/{i}.jpg")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_fsdp_trains_tests_and_resumes_on_two_ranks(tmp_path, capsys):
    places = _places(tmp_path / "places")
    save = tmp_path / "sd"
    common = ["--device", "cpu", "--channel_factor", "8",
              "--vgg_width_factor", "8", "--path_to_places365", places,
              "--fid_images", "5", "--num_workers", "2", "--lr", "1e-4",
              "--allow_random_fid", "--fid_device_stats",
              "--validate_after_n_iterations", "1000000",
              "--load_pretrained_vgg16", ""]
    sharded = ["--multihost", "--fsdp", "2", "--save_data_path", str(save)]
    outs = join(start(2, CLI + ["--train", "--test", "--epochs", "1",
                                "--batch_size", "2", "--log_every", "1"]
                      + common + sharded), timeout=240)
    (metrics,) = glob.glob(str(save / "metrics_*"))
    (models,) = glob.glob(str(save / "models_*"))
    assert os.listdir(models) == ["checkpoint_000.pt"]
    assert len(np.load(os.path.join(metrics, "loss_generator.npy"))) == 2
    assert glob.glob(os.path.join(save, "plots_*", "predictions_*.png"))
    fids = [re.search(r"FID= (\S+)", out).group(1) for out in outs]
    assert fids[0] == fids[1] and np.isfinite(float(fids[0]))
    ckpt = os.path.join(models, "checkpoint_000.pt")
    saved = torch.load(ckpt, weights_only=False)
    assert saved["step"] == 2
    assert all(type(t) is torch.Tensor for t in saved["generator"].values())

    outs = join(start(2, CLI + ["--test", "--batch_size", "2",
                                "--auto_resume", models] + common + sharded),
                timeout=240)
    for out in outs:
        assert f"auto-resumed from {ckpt} (step 2)" in out
    fids = [re.search(r"FID= (\S+)", out).group(1) for out in outs]
    assert fids[0] == fids[1] and np.isfinite(float(fids[0]))

    cli.main(["--test", "--batch_size", "2", "--load_checkpoint", ckpt,
              "--save_data_path", str(tmp_path / "one")] + common)
    printed = capsys.readouterr().out
    assert f"Restored checkpoint {ckpt} (step 2)" in printed
    assert np.isfinite(float(re.search(r"FID= (\S+)", printed).group(1)))
