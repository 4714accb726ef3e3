"""The port's long run (semantic_pyramid_for_image_generation_torch/scripts/
long_run.py) and its JPEG tree (scripts/jpeg_tree.py) against the
repository's scripts/long_run.py and bench.py, loaded through importlib.

Held, all exactly:
  * the tree: every file's bytes, train.txt and val.txt equal to JAX
    `long_run.make_tree`'s, and with val_per_class=0 to `bench.
    make_jpeg_tree`'s (2 classes, 3 per class, 64 px);
  * the flags: the port's parser takes the JAX script's flags plus
    --device, with its defaults except the two directories: the tree goes
    to the temporary directory under a name that gives its size, the run
    under --out (not fixed paths under /tmp, which a concurrent run
    shares). A tree of another size is refused, not trained on;
  * cli/main.py's argv: the port's equals the JAX script's with `--device`
    dropped, on the same flags. Both scripts run with their package's
    `cli.main.main` replaced by one fake that records its argv and writes
    the same metrics_*/*.npy and plots_*/predictions_*.png, so nothing
    trains;
  * summary.json on that fake run: equal to the JAX script's, except
    `wall_s` and `img_per_sec_end_to_end` (the clock) and the port's added
    `card`.
A real tiny run on the CPU (width factors 8, 2 classes of 4 JPEGs, batch 2,
4 steps, a validation every 2 steps with 4 FID images reduced on the
device) ends finite with 4 steps and 3 kept grids; `--device cuda` raises
on a host without a card before it writes anything.
"""

import importlib.util
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch.cli import main as port_cli
from semantic_pyramid_for_image_generation_torch.scripts import long_run
from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
    make_jpeg_tree,
)

REPO = Path(__file__).resolve().parents[1]
FAKE_STEPS = 300
FAKE_GRIDS = (0, 32768, 65536, 98304, 131072)
STAMP = "2000-01-01_00-00-00.000000"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


jax_long_run = _load("jax_long_run", REPO / "scripts" / "long_run.py")


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("reference", ["long_run", "bench"])
def test_tree_bytes_match_the_jax_scripts(tmp_path, reference):
    want = tmp_path / "want"
    if reference == "long_run":
        val = 2
        jax_long_run.make_tree(str(want), classes=2, per_class=3,
                               val_per_class=val, image_size=64)
    else:
        val = 0
        _load("jax_bench", REPO / "bench.py").make_jpeg_tree(
            str(want), 64, per_class=3, classes=2)
    got = tmp_path / "got"
    make_jpeg_tree(str(got), image_size=64, per_class=3, classes=2,
                   val_per_class=val)
    assert _files(got) == _files(want)
    assert len([n for n in _files(got) if n.endswith(".jpg")]) == 6 + 2 * val


def _help_flags(main, argv_prefix, monkeypatch, capsys) -> set:
    monkeypatch.setattr(sys, "argv", argv_prefix + ["--help"])
    with pytest.raises(SystemExit):
        main()
    return set(re.findall(r"--\w+", capsys.readouterr().out)) - {"--help"}


def test_flags_are_the_jax_scripts_plus_device(monkeypatch, capsys):
    jax_flags = _help_flags(jax_long_run.main, ["long_run.py"], monkeypatch,
                            capsys)
    port = {a for action in long_run.build_parser()._actions
            for a in action.option_strings if a.startswith("--")} - {"--help"}
    assert port == jax_flags | {"--device"}
    defaults = long_run.build_parser().parse_args([])
    assert (defaults.steps, defaults.batch, defaults.classes,
            defaults.validate_every_steps, defaults.data_dir,
            defaults.save_dir, defaults.device) == (
        2048, 64, 16, 512, None, None, "cuda")
    assert defaults.out == "saved_data/torch_longrun"
    dirs = long_run.with_dirs(defaults)
    assert dirs.data_dir == os.path.join(tempfile.gettempdir(),
                                         "torch_longrun_data_16x1024")
    assert dirs.save_dir == os.path.join("saved_data", "torch_longrun", "save")
    assert long_run.with_dirs(defaults, per_class=64).data_dir.endswith(
        "torch_longrun_data_16x64")


@pytest.mark.parametrize("present", [
    ("train.txt",), ("train.txt", "val.txt")])
def test_a_tree_of_another_size_is_refused(tmp_path, present):
    data = tmp_path / "data"
    make_jpeg_tree(str(data), image_size=64, per_class=3, classes=2,
                   val_per_class=long_run.VAL_PER_CLASS)
    for name in {"train.txt", "val.txt"} - set(present):
        (data / name).unlink()
    with pytest.raises(ValueError, match="not the 8 of a 2x4 tree|"
                                         "not the 32 of a 2x4 tree"):
        long_run.ensure_tree(str(data), classes=2, per_class=4)
    args = long_run.build_parser().parse_args([
        "--classes", "2", "--data_dir", str(data),
        "--save_dir", str(tmp_path / "sd"), "--out", str(tmp_path / "out"),
        "--device", "cpu"])
    with pytest.raises(ValueError, match="remove"):
        long_run.run(args, per_class=4)
    assert not (tmp_path / "sd").exists()


def _fake_cli(calls: list):
    """cli.main.main stand-in: records argv, writes one fake run's metrics
    and grids under --save_data_path."""
    def main(argv):
        calls.append(list(argv))
        save = argv[argv.index("--save_data_path") + 1]
        metrics = Path(save) / f"metrics_{STAMP}"
        plots = Path(save) / f"plots_{STAMP}"
        metrics.mkdir(parents=True)
        plots.mkdir(parents=True)
        rng = np.random.default_rng(3)
        curves = {
            "iterations": 64.0 * np.arange(1, FAKE_STEPS + 1),
            "loss_generator": rng.uniform(0.2, 0.6, FAKE_STEPS),
            "loss_discriminator_real": rng.uniform(0.1, 0.3, FAKE_STEPS),
            "loss_discriminator_fake": rng.uniform(0.1, 0.3, FAKE_STEPS),
            "loss_generator_semantic_reconstruction":
                np.linspace(0.05, 0.02, FAKE_STEPS) + rng.uniform(
                    0, 1e-3, FAKE_STEPS),
            "loss_generator_diversity": rng.uniform(-0.1, 0, FAKE_STEPS),
            "fid": np.array([412.345, 300.5, 250.25, 201.125]),
            "iterations_fid": np.array([4800.0, 9600.0, 14400.0, 19200.0]),
        }
        for name, values in curves.items():
            np.save(metrics / f"{name}.npy", values.astype(np.float32))
        from PIL import Image

        for samples in FAKE_GRIDS:
            Image.new("RGB", (8, 8), (samples % 251, 0, 0)).save(
                plots / f"predictions_{samples}.png")
        return 0
    return main


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The JAX script's main and the port's run on one fake run each:
    (jax argv, jax summary, port argv, port summary, port out dir)."""
    root = tmp_path_factory.mktemp("fake_runs")
    data = root / "data"
    data.mkdir()
    # a tree's index files of the default size: no tree is built
    args = long_run.build_parser().parse_args([])
    for name, per_class in (("train.txt", long_run.PER_CLASS),
                            ("val.txt", long_run.VAL_PER_CLASS)):
        (data / name).write_text("x.jpg\n" * (args.classes * per_class))
    import semantic_pyramid_for_image_generation_tpu.cli.main as jax_cli

    jax_calls, port_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "main", _fake_cli(jax_calls))
        mp.setattr(port_cli, "main", _fake_cli(port_calls))
        mp.setattr(sys, "argv", [
            "long_run.py", "--data_dir", str(data),
            "--save_dir", str(root / "jax_sd"), "--out", str(root / "jax")])
        assert jax_long_run.main() == 0
        args = long_run.build_parser().parse_args([
            "--data_dir", str(data), "--save_dir", str(root / "port_sd"),
            "--out", str(root / "port"), "--device", "cpu"])
        port_summary = long_run.run(args)
    with open(root / "jax" / "summary.json") as f:
        jax_summary = json.load(f)
    assert len(jax_calls) == len(port_calls) == 1
    return jax_calls[0], jax_summary, port_calls[0], port_summary, root / "port"


def test_cli_argv_is_the_jax_scripts(fake_runs):
    jax_argv, _, port_argv, _, _ = fake_runs
    assert port_argv[-2:] == ["--device", "cpu"]
    save = port_argv.index("--save_data_path") + 1
    assert port_argv[save].endswith("port_sd")
    assert jax_argv[save].endswith("jax_sd")
    assert port_argv[:save] + port_argv[save + 1:-2] == \
        jax_argv[:save] + jax_argv[save + 1:]
    args = long_run.build_parser().parse_args([])
    epochs = int(jax_argv[jax_argv.index("--epochs") + 1])
    assert long_run.epochs_for(args.steps, args.classes, args.batch) == epochs
    assert long_run.epochs_for(4, 2, 64, per_class=64) == 2


def test_summary_is_the_jax_scripts(fake_runs):
    _, jax_summary, _, port_summary, out = fake_runs
    clock = {"wall_s", "img_per_sec_end_to_end"}
    assert set(port_summary) == set(jax_summary) | {"card"}
    assert port_summary["card"] == "cpu"
    assert {k: v for k, v in port_summary.items()
            if k not in clock | {"card"}} == {
        k: v for k, v in jax_summary.items() if k not in clock}
    with open(out / "summary.json") as f:
        assert json.load(f) == port_summary
    assert port_summary["grids_kept"] == [
        "predictions_0.png", "predictions_65536.png", "predictions_131072.png"]
    for name in port_summary["grids_kept"] + ["loss_curves.png"]:
        assert (out / name).stat().st_size > 0


def test_tiny_run_on_the_cpu(tmp_path):
    args = long_run.build_parser().parse_args([
        "--classes", "2", "--batch", "2", "--steps", "4",
        "--validate_every_steps", "2", "--data_dir", str(tmp_path / "data"),
        "--save_dir", str(tmp_path / "sd"), "--out", str(tmp_path / "out"),
        "--device", "cpu"])
    summary = long_run.run(args, per_class=4, extra_cli_args=[
        "--channel_factor", "8", "--vgg_width_factor", "8",
        "--fid_images", "4", "--fid_device_stats"])
    assert summary["all_finite"] is True
    assert summary["steps"] == 4 and summary["samples"] == 8
    assert summary["grids_kept"] == [
        "predictions_0.png", "predictions_4.png", "predictions_8.png"]
    assert summary["fid_iterations"] == [4, 8]
    assert len(list((tmp_path / "sd").glob("models_*/checkpoint_*.pt"))) == 1
    assert (tmp_path / "out" / "loss_curves.png").stat().st_size > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        long_run.main(["--data_dir", str(tmp_path / "data"),
                       "--save_dir", str(tmp_path / "sd"),
                       "--out", str(tmp_path / "out")])
    assert not (tmp_path / "data").exists()
