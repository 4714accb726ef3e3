"""The port's artifact-readiness selftest
(semantic_pyramid_for_image_generation_torch/scripts/artifact_selftest.py)
against the repository's scripts/artifact_selftest.py, loaded through
importlib as tests/test_artifact_selftest.py loads it.

Stand-ins, as that test makes them: a 2-class, 4-per-split Places365 tree of
256x256 JPEGs, width-16 VGG-16 `.pt` files written from JAX variables by the
JAX package's `export_vgg16_state_dict` (the variables are the port's
seeded inits carried over by utils/pt_interop.py; seed 0 for the caffe
stand-in, seed 1 for the fine-tuned one), and the torchvision-keyed
`tests/torch_inception.py::randomized_mirror(0)`. The run_fid test adds a
reference-layout `.pt` GAN checkpoint at channel factor 16.

Held, with their tolerances:
  * the JSON reports and exit codes of --check-only and of the vacuous pass:
    equal to the JAX script's;
  * run_vgg_accuracy: top-1 and top-5 equal to the JAX script's;
  * run_self_fid: the two halves' activations elementwise against the JAX
    evaluator's on the JAX loader's batches (fp32, atol 3e-4 of the mean
    |activation| (at least 1), rtol 2e-4: tests/test_torch_fid.py's bar),
    and the FID relative 1e-3 against the JAX package's
    `fid_from_activations` of the JAX activations, taken in an orthonormal
    basis of the span of their centred rows and mean difference (the FID
    reads nothing outside that span and is invariant under the change of
    basis; the JAX evaluation's own 2048-dim sqrtm would cost ~20 s on one
    core);
  * run_fid: the JAX script's whole FID builds the JAX Trainer (a flax init
    of three networks, ~100 s here), and the latents cannot be pinned
    across torch.Generator and jax.random, so its pieces are held: the
    cli/main.py flags and the config both scripts build (equal), the real
    images' moments (relative 1e-3 of each array's largest entry, the bar
    of tests/test_torch_fid.py) and a finite FID from the restored
    checkpoint's G.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch.scripts import (
    artifact_selftest as selftest,
)

REPO = Path(__file__).resolve().parents[1]
WIDTH = 16
BATCH = 4
CPU = torch.device("cpu")


def _load_jax_selftest():
    spec = importlib.util.spec_from_file_location(
        "jax_artifact_selftest", REPO / "scripts" / "artifact_selftest.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_artifact_selftest"] = module
    spec.loader.exec_module(module)
    return module


jax_selftest = _load_jax_selftest()


def _vgg_pt(seed: int, path: Path) -> None:
    """A width-16 VGG-16 .pt in the reference's `vgg16.*` keys, written by
    the JAX package from JAX variables (the port's seeded init, bridged)."""
    from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
        export_vgg16_state_dict,
    )
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        vgg16_flax_from_state_dict,
    )

    model = VGG16(PyramidGANConfig(vgg_width_factor=WIDTH), return_output=True)
    model.initialize(torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    # the stand-in tree's two classes lead every image's logits, so top-5 is
    # 100% and top-1 is decided by the image (random weights alone score 0)
    sd["vgg16.classifier.6.bias"][:2] += 100.0
    params = vgg16_flax_from_state_dict(sd)
    torch.save(export_vgg16_state_dict({"params": params}), str(path))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    from PIL import Image

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )
    from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
        reference_gan_checkpoint,
    )
    from torch_inception import randomized_mirror

    root = tmp_path_factory.mktemp("artifact_standins")
    rng = np.random.default_rng(0)
    places = root / "places365_standard"
    for split, n in (("train", 4), ("val", 4)):
        lines = []
        for cls in ("a_forest", "b_beach"):
            d = places / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                img = Image.fromarray(arr).resize((256, 256), Image.BILINEAR)
                img.save(str(d / f"{i:02d}.jpg"), quality=85)
                lines.append(f"{split}/{cls}/{i:02d}.jpg")
        (places / f"{split}.txt").write_text("\n".join(lines) + "\n")
    _vgg_pt(0, root / "vgg_raw.pt")
    _vgg_pt(1, root / "vgg_finetuned.pt")
    torch.save(randomized_mirror(seed=0).state_dict(),
               str(root / "inception.pth"))
    state = init_train_state(
        PyramidGANConfig(channels_factor=WIDTH, vgg_width_factor=WIDTH,
                         compute_dtype="bfloat16"), CPU, seed=3)
    state.step = 7
    torch.save(reference_gan_checkpoint(state), str(root / "gan.pt"))
    return root


def _argv(root, **overrides):
    """tests/test_artifact_selftest.py's command line (relaxed
    expectations: random weights, so any finite value passes)."""
    argv = [
        "--device", "cpu",
        "--places", str(root / "places365_standard"),
        "--vgg_pt", str(root / "vgg_raw.pt"),
        "--vgg_finetuned_pt", str(root / "vgg_finetuned.pt"),
        "--inception_pt", str(root / "inception.pth"),
        "--batch_size", str(BATCH), "--num_workers", "2",
        "--fid_images", "4", "--self_fid_images", "4", "--scan_group", "1",
        "--channel_factor", "16", "--vgg_width_factor", str(WIDTH),
        "--expect_top1_before", "50.0", "60.0",
        "--expect_top5_before", "50.0", "60.0",
        "--expect_top1_after", "50.0", "60.0",
        "--expect_top5_after", "50.0", "60.0",
        "--expect_self_fid_max", "1e9",
        "--expect_fid_band", "0.0", "1e9",
    ]
    for flag, values in overrides.items():
        i = argv.index(flag)
        argv[i + 1:i + 1 + len(values)] = values
    return argv


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PRESENCE = {"none": (), "places": ("places",),
            "weights": ("vgg_pt", "vgg_finetuned_pt", "inception_pt"),
            "all": ("places", "vgg_pt", "vgg_finetuned_pt", "inception_pt")}


@pytest.mark.parametrize("present", PRESENCE)
def test_check_only_matches_jax(tmp_path, capsys, present):
    argv = ["--check-only"]
    for flag in ("places", "vgg_pt", "vgg_finetuned_pt", "inception_pt"):
        path = tmp_path / flag
        if flag in PRESENCE[present]:
            if flag == "places":
                (path / "val").mkdir(parents=True)
            else:
                path.write_bytes(b"x")
        argv += [f"--{flag}", str(path)]
    rc = selftest.main(argv)
    report = _report(capsys)
    assert rc == jax_selftest.main(argv)
    assert report == _report(capsys)
    if present == "none":  # the JAX test's case
        assert rc == 1 and report["ready"] is False
        assert set(report["missing"]) == {"inception", "vgg_caffe",
                                          "vgg_finetuned", "places365"}
    assert rc == (0 if present == "all" else 1)


def test_no_unlocked_evaluation_is_a_vacuous_pass(tmp_path, capsys):
    """Weights present, no Places365: nothing runs, so no device is asked
    for (the port's default is cuda), rc 0 and an empty `checks`."""
    argv = ["--places", str(tmp_path / "nowhere")]
    for flag, name in (("--vgg_pt", "w.pt"), ("--vgg_finetuned_pt", "wf.pt"),
                       ("--inception_pt", "i.pth")):
        (tmp_path / name).write_bytes(b"x")
        argv += [flag, str(tmp_path / name)]
    rc = selftest.main(argv)
    report = _report(capsys)
    assert rc == 0 == jax_selftest.main(argv)
    assert report == _report(capsys) == {
        "ready": False, "results": {}, "checks": {}, "passed": True}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without "
                    "a card")
def test_an_evaluation_without_a_card_raises(artifacts, capsys):
    """Places365 present, no --device: the default cuda raises here instead
    of running on the CPU."""
    argv = _argv(artifacts)
    del argv[:2]  # --device cpu
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        selftest.main(argv)


@pytest.fixture(scope="module")
def jax_accuracy(artifacts):
    """The JAX script's (top-1, top-5) per weights file."""
    args = jax_selftest.build_parser().parse_args(_argv(artifacts))
    return {name: jax_selftest.run_vgg_accuracy(args, str(artifacts / name))
            for name in ("vgg_raw.pt", "vgg_finetuned.pt")}


@pytest.mark.parametrize("name", ["vgg_raw.pt", "vgg_finetuned.pt"])
def test_vgg_accuracy_matches_jax(artifacts, jax_accuracy, name):
    args = selftest.build_parser().parse_args(_argv(artifacts))
    got = selftest.run_vgg_accuracy(args, str(artifacts / name))
    assert got == pytest.approx(jax_accuracy[name], abs=1e-9)
    assert got[1] == 100.0  # see _vgg_pt


def test_vgg_accuracy_of_a_missing_file_raises(artifacts):
    """A direct call does not fall back to random weights."""
    args = selftest.build_parser().parse_args(_argv(artifacts))
    with pytest.raises(FileNotFoundError):
        selftest.run_vgg_accuracy(args, str(artifacts / "absent.pt"))


def test_fid_checks_gated_on_inception(artifacts, jax_accuracy, capsys):
    """tests/test_artifact_selftest.py's gating case through the port's
    main(): without the Inception file neither FID runs, the four
    accuracies do, and each equals the JAX script's."""
    rc = selftest.main(_argv(artifacts, **{
        "--inception_pt": [str(artifacts / "absent.pth")]}))
    report = _report(capsys)
    assert rc == 0 and report["ready"] is False and report["passed"] is True
    want = {}
    for when, name in (("before", "vgg_raw.pt"), ("after", "vgg_finetuned.pt")):
        top1, top5 = jax_accuracy[name]
        want[f"vgg_top1_{when}"] = round(top1, 4)
        want[f"vgg_top5_{when}"] = round(top5, 4)
    assert report["results"] == want
    assert set(report["checks"]) == set(want)


def test_a_failed_check_fails_the_run(artifacts, capsys):
    """One impossible expectation: exactly that check fails, and so do
    `passed` and the exit code."""
    rc = selftest.main(_argv(artifacts, **{
        "--inception_pt": [str(artifacts / "absent.pth")],
        "--expect_top5_before": ["99.9", "1e-6"]}))
    report = _report(capsys)
    assert rc == 1 and report["passed"] is False
    checks = report["checks"]
    assert checks.pop("vgg_top5_before") is False
    assert checks and all(checks.values())


def _jax_evaluator(artifacts):
    from semantic_pyramid_for_image_generation_tpu.eval.fid import (
        FIDEvaluator,
    )
    from semantic_pyramid_for_image_generation_tpu.models.inception import (
        convert_inception_state_dict,
    )

    return FIDEvaluator(convert_inception_state_dict(
        torch.load(str(artifacts / "inception.pth"))))


def _fid_in_span(real, fake):
    """The JAX package's fid_from_activations of (real, fake) in an
    orthonormal basis of the span of their centred rows and mean difference:
    the same FID (every term it reads lies in that span)."""
    from semantic_pyramid_for_image_generation_tpu.eval.fid import (
        fid_from_activations,
    )

    real, fake = real.astype(np.float64), fake.astype(np.float64)
    mu_r, mu_f = real.mean(0), fake.mean(0)
    q, _ = np.linalg.qr(np.concatenate(
        [real - mu_r, fake - mu_f, (mu_r - mu_f)[None]]).T)
    return fid_from_activations(real @ q, fake @ q)


def test_self_fid_matches_jax(artifacts, monkeypatch, capsys):
    from semantic_pyramid_for_image_generation_tpu.config import (
        PyramidGANConfig as JaxConfig,
    )
    from semantic_pyramid_for_image_generation_tpu.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.eval import fid

    seen = {}
    real_fid = fid.fid_from_activations

    def recording(real, fake):
        seen["halves"] = (real, fake)
        return real_fid(real, fake)

    monkeypatch.setattr(fid, "fid_from_activations", recording)
    args = selftest.build_parser().parse_args(_argv(artifacts))
    got = selftest.run_self_fid(args)
    assert "self-FID" in capsys.readouterr().out

    # the JAX script's walk, through the JAX evaluator
    evaluator = _jax_evaluator(artifacts)
    loader = Places365Loader(
        Places365(args.places, "val.txt", JaxConfig(),
                  max_length=2 * args.self_fid_images, validation=True),
        batch_size=min(50, args.batch_size), shuffle=False, drop_last=True,
        num_workers=args.num_workers)
    halves = [[], []]
    for i, batch in enumerate(loader):
        halves[i % 2].append(evaluator.activations(batch["images"]))
    want = [np.concatenate(h) for h in halves]
    for g, w in zip(seen["halves"], want):
        assert g.shape == w.shape == (4, 2048)
        scale = max(float(np.abs(w).mean()), 1.0)
        np.testing.assert_allclose(g, w, atol=3e-4 * scale, rtol=2e-4)
    want_fid = _fid_in_span(*want)
    assert np.isfinite(got) and want_fid > 0
    np.testing.assert_allclose(got, want_fid, rtol=1e-3)


def test_fid_run_matches_jax_pieces(artifacts, monkeypatch, tmp_path):
    from semantic_pyramid_for_image_generation_tpu.cli import (
        main as jax_cli_main,
    )
    from semantic_pyramid_for_image_generation_tpu.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.cli import main as cli_main

    monkeypatch.chdir(tmp_path)  # the Trainer's run directories go here
    argv = _argv(artifacts) + [
        "--load_checkpoint", str(artifacts / "gan.pt")]

    built = {}
    build_trainer = cli_main.build_trainer

    def capturing(parsed):
        built["args"] = parsed
        built["trainer"] = build_trainer(parsed)
        return built["trainer"]

    monkeypatch.setattr(cli_main, "build_trainer", capturing)
    got = selftest.run_fid(selftest.build_parser().parse_args(argv))
    assert np.isfinite(got) and got > 0

    class Built(Exception):
        pass

    def stop(parsed):  # the JAX Trainer is not built (see the docstring)
        built["jax_args"] = parsed
        raise Built

    monkeypatch.setattr(jax_cli_main, "build_trainer", stop)
    with pytest.raises(Built):
        jax_selftest.run_fid(jax_selftest.build_parser().parse_args(argv))
    ours, theirs = vars(built["args"]), vars(built["jax_args"])
    for key in ("test", "path_to_places365", "fid_images", "batch_size",
                "num_workers", "channel_factor", "vgg_width_factor",
                "load_inception", "load_pretrained_vgg16", "load_checkpoint",
                "device", "dtype", "seed"):
        assert ours[key] == theirs[key], key
    config = jax_cli_main.config_from_args(built["jax_args"])
    assert dataclasses.asdict(cli_main.config_from_args(built["args"])) == \
        dataclasses.asdict(config)

    trainer = built["trainer"]
    checkpoint = torch.load(str(artifacts / "gan.pt"))
    assert trainer.state.step == checkpoint["step"] == 7
    for key, value in checkpoint["generator"].items():
        torch.testing.assert_close(trainer.state.generator.state_dict()[key],
                                   value, rtol=0, atol=0, msg=key)
    n, totals = trainer.fid_evaluator.last_moments
    assert n == 4
    evaluator = _jax_evaluator(artifacts)
    real = np.concatenate([
        evaluator.activations(batch["images"]) for batch in Places365Loader(
            Places365(argv[argv.index("--places") + 1], "val.txt", config,
                      max_length=4, validation=True),
            batch_size=2 * BATCH, shuffle=True, drop_last=False,
            num_workers=2)]).astype(np.float64)
    for name, g, w in (("real sum", totals[0], real.sum(0)),
                       ("real outer", totals[1], real.T @ real)):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
