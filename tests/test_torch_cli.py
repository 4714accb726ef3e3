"""The training CLI on several processes: `--multihost` under a 2-rank gloo
launch on the CPU (each rank told its rank as torchrun tells it), on a mini
Places365 tree.

  * Training: one run directory, written by rank 0 alone, with
    `checkpoint_000.pt`, the metrics (every step logged once, `iterations`
    counting the global batch) and the grids.
  * A rerun with `--test --auto_resume` restores the checkpoint on both
    ranks, and both print the same FID.
  * The batch size rounds to a multiple of the world size.

  * Ranks that read different files raise: each rank runs in its own
    directory, and a relative `--load_pretrained_vgg16` or `--auto_resume`
    names a file that only rank 0's directory holds.

`--fsdp` > 1 shards the state over these ranks
(tests/test_torch_fsdp_cli.py); the values it refuses are held in
tests/test_torch_trainer.py::test_fsdp_flags_that_cannot_shard_raise.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from torch_parallel_rank import join, start

CLI = ["-m", "semantic_pyramid_for_image_generation_torch.cli.main"]


@pytest.fixture(scope="module")
def places_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("placesmini")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        lines = []
        for cls in ("abbey", "zoo"):
            (root / split / cls).mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 255, (256, 256, 3),
                                             dtype=np.uint8)).save(
                    root / split / cls / f"{i}.jpg")
                lines.append(f"{split}/{cls}/{i}.jpg")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_multihost_trains_on_two_ranks_and_resumes(places_root, tmp_path):
    save = tmp_path / "sd"
    common = ["--multihost", "--device", "cpu", "--channel_factor", "8",
              "--vgg_width_factor", "8", "--path_to_places365", places_root,
              "--fid_images", "4", "--num_workers", "2", "--lr", "1e-4",
              "--allow_random_fid", "--fid_device_stats",
              "--validate_after_n_iterations", "1000000",
              "--save_data_path", str(save)]
    # a global batch of 3 rounds to 2: one row per rank, two steps
    outs = join(start(2, CLI + ["--train", "--epochs", "1", "--batch_size",
                                "3", "--log_every", "1"] + common),
                timeout=240)
    assert all("batch_size 3 -> 2 (a multiple of the 2 ranks)" in out
               for out in outs)
    (metrics,) = glob.glob(str(save / "metrics_*"))
    (models,) = glob.glob(str(save / "models_*"))
    assert len(glob.glob(str(save / "plots_*"))) == 1
    assert os.listdir(models) == ["checkpoint_000.pt"]
    assert len(np.load(os.path.join(metrics, "loss_generator.npy"))) == 2
    np.testing.assert_array_equal(
        np.load(os.path.join(metrics, "iterations.npy")), [2.0, 4.0])
    grids = glob.glob(os.path.join(save, "plots_*", "predictions_*.png"))
    assert grids
    with Image.open(grids[0]) as img:
        assert img.size == (7 * 256 + 8 * 2,) * 2

    outs = join(start(2, CLI + ["--test", "--batch_size", "2",
                                "--auto_resume", models] + common),
                timeout=240)
    for out in outs:
        assert f"auto-resumed from {models}/checkpoint_000.pt (step 2)" in out
    fids = [re.search(r"FID= (\S+)", out).group(1) for out in outs]
    assert fids[0] == fids[1] and np.isfinite(float(fids[0]))


@pytest.mark.parametrize("what", ["vgg", "auto_resume"])
def test_multihost_ranks_that_read_different_files_raise(places_root,
                                                         tmp_path, what):
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.train.checkpoint import (
        save_checkpoint,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )

    own = [tmp_path / "rank0", tmp_path / "rank1"]
    for d in own:
        d.mkdir()
    state = init_train_state(
        PyramidGANConfig(channels_factor=8, vgg_width_factor=8),
        torch.device("cpu"), lr=1e-4, seed=1)
    if what == "vgg":
        torch.save(state.vgg.state_dict(), own[0] / "vgg.pt")
        flags = ["--load_pretrained_vgg16", "vgg.pt"]
        message = "ranks [1] hold another state than rank 0"
    else:
        save_checkpoint(str(own[0] / "models"), state, step=0)
        flags = ["--load_pretrained_vgg16", "", "--auto_resume", "models"]
        message = "No such file or directory"
    procs = start(2, CLI + [
        "--multihost", "--device", "cpu", "--channel_factor", "8",
        "--vgg_width_factor", "8", "--path_to_places365", places_root,
        "--num_workers", "1", "--batch_size", "2", "--allow_random_fid",
        "--save_data_path", str(tmp_path / "sd")] + flags, cwds=own)
    with pytest.raises(AssertionError, match="exited") as raised:
        join(procs, timeout=240)
    assert message in str(raised.value)
