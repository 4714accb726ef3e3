"""The port's VGG-16 fine-tune (cli/vgg16_finetune.py, cli/vgg16_infer.py)
against the JAX package's, on the CPU at tiny widths (VGG widths / 16).

Both sides start from one init: the port's seeded VGG16, carried into the
JAX package by its own `convert_vgg16_state_dict`. The dropout masks of a
JAX step are recovered with a `capture_intermediates` probe (kept = output
!= 0; where a ReLU'd input is exactly 0 the mask changes neither the value
nor the gradient) and pinned into the port's step.

Tolerances:
  * the step, fp32, two steps at epochs 0 and 30 (lr 1e-4, then the decade
    decay to 1e-5): loss within 1e-5 relative, top-1 equal. Parameters
    after each step within 1e-2 of that step's lr plus one fp32 ulp of the
    parameter on all but 0.1% of the elements, and every element within
    4 * lr. Adam divides each gradient by its own magnitude, so an element
    whose gradient sits at the fp32 noise floor takes a +-lr step of either
    sign in either framework (tests/test_torch_train_step.py has the
    longer argument).
  * the step, bf16, one step: loss within 2% relative; parameters within
    2 * lr + one fp32 ulp everywhere (Adam's first step is +-lr per
    element), the sign of the step the same on all but 5% of the elements.
    The two frameworks round to bf16 in other places.
  * eval step, fp32: per-sample cross-entropy within 1e-5 relative, top-1
    and top-5 equal. `run_validation`: loss within 1e-5 relative, Prec@1
    and Prec@5 within 1e-6 (the JAX meters average float32 means).
  * `--resume`: bitwise against a straight run (weights and Adam state).
  * `--export_pt`: key for key and value for value against the JAX
    package's `export_vgg16_state_dict` of the bridged parameters, exact.
  * `vgg16_infer`: the printed argmax and labels equal the JAX CLI's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from semantic_pyramid_for_image_generation_tpu.cli import (
    vgg16_infer as jax_infer,
)
from semantic_pyramid_for_image_generation_tpu.cli.vgg16_finetune import (
    build_parser as jax_build_parser,
)
from semantic_pyramid_for_image_generation_tpu.cli.vgg16_finetune import (
    make_eval_step as jax_make_eval_step,
)
from semantic_pyramid_for_image_generation_tpu.cli.vgg16_finetune import (
    make_finetune_step as jax_make_finetune_step,
)
from semantic_pyramid_for_image_generation_tpu.cli.vgg16_finetune import (
    run_validation as jax_run_validation,
)
from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.data.image_folder import (
    ImageFolder as JaxImageFolder,
)
from semantic_pyramid_for_image_generation_tpu.data.image_folder import (
    ImageFolderLoader as JaxImageFolderLoader,
)
from semantic_pyramid_for_image_generation_tpu.models import (
    VGG16 as JaxVGG16,
)
from semantic_pyramid_for_image_generation_tpu.parallel.mesh import (
    make_mesh,
    shard_batch,
)
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_vgg16_state_dict,
    export_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.cli import vgg16_finetune as ft
from semantic_pyramid_for_image_generation_torch.cli import vgg16_infer
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.image_folder import (
    ImageFolder,
    ImageFolderLoader,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
    VGG16,
    dropout_keep_mask,
)

WIDTH = 16
IMG = 32
LR = 1e-4
CPU = torch.device("cpu")


def _cfgs(classes, dtype="float32"):
    kw = dict(compute_dtype=dtype, vgg_width_factor=WIDTH, image_size=IMG,
              num_classes=classes)
    return PyramidGANConfig(**kw), JaxConfig(**kw)


def _model(cfg, seed=0):
    model = VGG16(cfg, return_output=True)
    model.initialize(torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last)


def _batch(n, classes, seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32)
    return images, rng.integers(0, classes, n).astype(np.int32)


def _dropout_masks(model, params, images, step_rng):
    """The two keep masks the JAX model draws for (params, images, rng)."""
    _, state = model.apply(
        {"params": params}, images, train=True, rngs={"dropout": step_rng},
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    inter = state["intermediates"]
    return [np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0
            for i in range(2)]


def _param_errors(model, params):
    want = export_vgg16_state_dict({"params": params})
    return {k: (v.detach() - want[k]).abs() for k, v in
            model.state_dict().items()}, model.state_dict()


# ------------------------------------------------------------- the step --


def test_finetune_step_matches_jax_fp32():
    cfg, jcfg = _cfgs(3)
    model = _model(cfg)
    params = convert_vgg16_state_dict(model.state_dict())["params"]
    jmodel = JaxVGG16(jcfg, return_output=True)
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    jstep = jax_make_finetune_step(jmodel, tx)
    optimizer = ft.make_optimizer(model, LR)
    step = ft.make_finetune_step(model, optimizer)
    for i, epoch in enumerate((0, 30)):
        images, labels = _batch(4, 3, seed=i)
        step_rng = jax.random.fold_in(jax.random.key(1), epoch)
        masks = _dropout_masks(jmodel, params, jnp.asarray(images), step_rng)
        params, opt_state, jloss, jtop1 = jstep(
            params, opt_state, jnp.asarray(images), jnp.asarray(labels),
            step_rng, jnp.float32(ft.epoch_lr_scale(epoch)))
        ft.set_epoch_lr(optimizer, LR, epoch)
        x, y = ft.batch_to_device(images, labels, CPU)
        loss, top1 = step(x, y, dropout_masks=[torch.from_numpy(m)
                                               for m in masks])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(top1) == float(jtop1)
        lr = LR * ft.epoch_lr_scale(epoch)
        errors, got = _param_errors(model, params)
        off = total = 0
        for key, err in errors.items():
            assert float(err.max()) <= 4 * LR, key
            off += int((err > 1e-2 * lr + 2.0 ** -23 * got[key].abs()).sum())
            total += err.numel()
        assert off <= 1e-3 * total, f"step {i}: {off} of {total} elements off"
    assert optimizer.param_groups[0]["lr"] == pytest.approx(LR / 10)


def test_finetune_step_bf16_in_bands():
    cfg, jcfg = _cfgs(3, "bfloat16")
    model = _model(cfg, seed=1)
    params = convert_vgg16_state_dict(model.state_dict())["params"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jmodel = JaxVGG16(jcfg, return_output=True)
    tx = optax.adam(LR)
    images, labels = _batch(4, 3, seed=7)
    step_rng = jax.random.key(3)
    masks = _dropout_masks(jmodel, params, jnp.asarray(images), step_rng)
    params, _, jloss, _ = jax_make_finetune_step(jmodel, tx)(
        params, tx.init(params), jnp.asarray(images), jnp.asarray(labels),
        step_rng, jnp.float32(1.0))
    optimizer = ft.make_optimizer(model, LR)
    x, y = ft.batch_to_device(images, labels, CPU)
    loss, _ = ft.make_finetune_step(model, optimizer)(
        x, y, dropout_masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    errors, got = _param_errors(model, params)
    want = export_vgg16_state_dict({"params": params})
    flipped = total = 0
    for key, err in errors.items():
        assert float((err - 2.0 ** -23 * got[key].abs()).max()) <= 2 * LR, key
        flipped += int((torch.sign(got[key] - before[key])
                        != torch.sign(want[key] - before[key])).sum())
        total += err.numel()
    assert flipped <= 0.05 * total, f"{flipped} of {total} steps differ"


def test_dropout_masks_are_seeded_and_applied_as_flax():
    cfg, _ = _cfgs(3)
    model = _model(cfg).train()
    a = dropout_keep_mask((64, 256), CPU, ft.dropout_generator(2, 5, CPU))
    b = dropout_keep_mask((64, 256), CPU, ft.dropout_generator(2, 5, CPU))
    c = dropout_keep_mask((64, 256), CPU, ft.dropout_generator(2, 6, CPU))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.45 < float(a.float().mean()) < 0.55
    x, _ = ft.batch_to_device(*_batch(2, 3, seed=0), CPU)
    fc = cfg.vgg_fc7_dim
    ones = [torch.ones(2, fc, dtype=torch.bool)] * 2
    kept = model(x, dropout_masks=ones)
    # all kept still scales by 1 / 0.5, so training mode differs from eval
    with torch.no_grad():
        evaluated = model.eval()(x)
    assert not torch.allclose(kept, evaluated)
    model.train()
    zeros = [torch.zeros(2, fc, dtype=torch.bool)] * 2
    dropped = model(x, dropout_masks=zeros)
    bias = model.vgg16.classifier[6].bias
    torch.testing.assert_close(dropped, bias.expand(2, -1), rtol=0, atol=0)


# --------------------------------------------------- the batch's copy --


def _noncontiguous_float64(n, classes, seed):
    """A float64 NHWC batch that is a strided view (every other row and
    column of a larger array), with int64 labels."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 2 * IMG, 2 * IMG, 3))[:, ::2, ::2]
    return images, rng.integers(0, classes, n)


@pytest.mark.parametrize("source", [_batch, _noncontiguous_float64])
def test_batch_to_device_on_cpu_is_the_plain_copy(source):
    """On the CPU the batch takes the plain path: float32 images as the
    NCHW permute of the NHWC array numpy casts, int64 labels, the values
    unchanged, strides those of the permuted NHWC batch."""
    images, labels = source(5, 3, seed=1)
    want = torch.from_numpy(np.asarray(images, np.float32)).permute(0, 3, 1, 2)
    x, y = ft.batch_to_device(images, labels, CPU)
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    assert x.shape == (5, 3, IMG, IMG) and y.shape == (5,)
    assert x.stride() == want.stride()
    assert torch.equal(x, want)
    np.testing.assert_array_equal(y.numpy(), labels)


def test_batch_to_device_on_cpu_counts_plain_copies():
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        to_device_counts,
    )

    before = to_device_counts()
    for seed in range(3):
        ft.batch_to_device(*_batch(2, 3, seed=seed), CPU)
    after = to_device_counts()
    assert after == {"staged": before["staged"],
                     "plain": before["plain"] + 3}


# ------------------------------------------------------ eval, validation --


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An ImageFolder tree: train 2 classes x 8, val 6 classes x 3 (so a
    remainder batch and non-trivial top-5), 32x32 PNGs."""
    root = tmp_path_factory.mktemp("finetune_tree")
    rng = np.random.default_rng(0)
    for split, classes, n in (("train", 2, 8), ("val", 6, 3)):
        for c in range(classes):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3),
                                             dtype=np.uint8)).save(d / f"{i}.png")
    return str(root)


def test_eval_step_matches_jax():
    cfg, jcfg = _cfgs(10)
    model = _model(cfg, seed=2)
    params = convert_vgg16_state_dict(model.state_dict())["params"]
    images, labels = _batch(8, 10, seed=4)
    want = jax_make_eval_step(JaxVGG16(jcfg, return_output=True))(
        params, jnp.asarray(images), jnp.asarray(labels))
    got = ft.make_eval_step(model)(*ft.batch_to_device(images, labels, CPU))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < float(got[2].sum()) < 8  # top-5 of 10 is not trivial here


def test_run_validation_matches_jax(tree):
    cfg, jcfg = _cfgs(10)
    model = _model(cfg, seed=3)
    params = convert_vgg16_state_dict(model.state_dict())["params"]
    kw = dict(shuffle=False, random_flip=False, drop_last=False,
              num_workers=2)
    val = os.path.join(tree, "val")
    want = jax_run_validation(
        jax_make_eval_step(JaxVGG16(jcfg, return_output=True)), params,
        JaxImageFolderLoader(JaxImageFolder(val, IMG), 4, **kw), make_mesh(),
        shard_batch)
    got = ft.run_validation(ft.make_eval_step(model),
                            ImageFolderLoader(ImageFolder(val, IMG), 4, **kw),
                            CPU)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-6)


# ------------------------------------------------------- the CLI, resume --


def _run(data, save_dir, epochs, resume=None, extra=()):
    argv = ["--device", "cpu", "--data", data, "--save_dir", save_dir,
            "--epochs", str(epochs), "--batch_size", "8", "--workers", "2",
            "--image_size", str(IMG), "--num_classes", "6",
            "--vgg_width_factor", str(WIDTH), "--dtype", "float32",
            "--load_vgg16", "", *extra]
    if resume:
        argv += ["--resume", resume]
    assert ft.main(argv) == 0


def _load(path):
    return torch.load(path, weights_only=True)


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


def test_resume_is_lossless(tree, tmp_path):
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    _run(tree, straight, epochs=2)
    _run(tree, resumed, epochs=1)
    leg1 = _load(os.path.join(resumed, "latest_0.pt"))
    assert set(leg1) == {"epoch", "state_dict", "optimizer", "best_prec1"}
    assert leg1["epoch"] == 1 and leg1["optimizer"]["state"]
    _run(tree, resumed, epochs=2, resume=resumed)
    want = _load(os.path.join(straight, "latest_1.pt"))
    got = _load(os.path.join(resumed, "latest_1.pt"))
    assert got["epoch"] == want["epoch"] == 2
    # the same data order (keyed on (seed, epoch)), dropout masks (keyed on
    # (epoch, step)) and Adam moments: the same weights, bit for bit
    assert _tree_equal(got["state_dict"], want["state_dict"])
    assert _tree_equal(got["optimizer"], want["optimizer"])
    assert got["best_prec1"] == want["best_prec1"] >= leg1["best_prec1"]
    # the checkpoint restores into a fresh model strictly, in module order
    model = _model(_cfgs(6)[0], seed=9)
    model.load_state_dict(got["state_dict"], strict=True)


def test_resume_skips_a_finished_run(tree, tmp_path, capsys):
    save_dir = str(tmp_path / "done")
    _run(tree, save_dir, epochs=1)
    before = set(os.listdir(save_dir))
    _run(tree, save_dir, epochs=1, resume=save_dir)
    out = capsys.readouterr().out
    assert "=> loaded checkpoint" in out and "(epoch 1" in out
    assert set(os.listdir(save_dir)) == before


def test_resume_from_a_missing_path_starts_fresh(tree, tmp_path, capsys):
    save_dir = str(tmp_path / "fresh")
    _run(tree, save_dir, epochs=1, resume=str(tmp_path / "nowhere"),
         extra=["--max_steps", "1"])
    assert "=> no checkpoint found" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(save_dir, "latest_0.pt"))


def test_resolve_resume_path(tmp_path):
    assert ft.resolve_resume_path(str(tmp_path / "missing")) is None
    assert ft.resolve_resume_path(str(tmp_path)) is None
    for name in ("latest_0.pt", "latest_2.pt", "latest_10.pt", "best.pt",
                 "latest_x.pt", "junk"):
        (tmp_path / name).write_bytes(b"")
    assert ft.resolve_resume_path(str(tmp_path)).endswith("latest_10.pt")
    assert ft.resolve_resume_path(str(tmp_path / "best.pt")).endswith("best.pt")
    save_dir = tmp_path / "latest_run"
    save_dir.mkdir()
    (save_dir / "latest_3.pt").write_bytes(b"")
    assert ft.resolve_resume_path(str(save_dir)).endswith(
        os.path.join("latest_run", "latest_3.pt"))


def test_lr_schedule():
    assert [ft.epoch_lr_scale(e) for e in (0, 29)] == [1.0, 1.0]
    assert ft.epoch_lr_scale(30) == pytest.approx(0.1)
    assert ft.epoch_lr_scale(60) == pytest.approx(0.01)


def test_evaluate_only_and_export_refused_below_full_width(tree, tmp_path,
                                                           capsys):
    _run(tree, str(tmp_path / "eval"), epochs=1, extra=["--evaluate_only"])
    assert "* Prec@1" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "eval")
    with pytest.raises(SystemExit, match="full-width"):
        _run(tree, str(tmp_path / "x"), epochs=1,
             extra=["--export_pt", str(tmp_path / "x.pt"), "--max_steps", "1"])


def test_parser_matches_jax_but_device():
    def defaults(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    got, want = defaults(ft.build_parser()), defaults(jax_build_parser())
    assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
    assert got == want


# ------------------------------------------------ export and inference --


def test_export_matches_jax_export_of_the_bridged_params():
    cfg, _ = _cfgs(365)
    model = _model(cfg, seed=5)
    got = ft.export_state_dict(model)
    want = export_vgg16_state_dict(convert_vgg16_state_dict(model.state_dict()))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].device == CPU
        assert torch.equal(got[key], value), key
    fresh = VGG16(cfg)
    fresh.load_state_dict(got, strict=True)


def test_infer_cli_matches_jax(tree, tmp_path, capsys):
    cfg, _ = _cfgs(365)
    pt = str(tmp_path / "vgg.pt")
    torch.save(ft.export_state_dict(_model(cfg, seed=6)), pt)
    argv = ["--data", tree, "--load_vgg16", pt, "--batch_size", "6",
            "--device", "cpu", "--vgg_width_factor", str(WIDTH),
            "--image_size", str(IMG)]

    def printed():
        out = capsys.readouterr().out
        return {k: re.search(rf"{re.escape(k)}(.*?)(?=\n\S|\Z)", out,
                             re.S).group(1).split()
                for k in ("predictions (argmax):", "labels:")}

    assert jax_infer.main(argv) == 0
    want = printed()
    assert vgg16_infer.main(argv) == 0
    got = printed()
    assert got == want and len(got["labels:"]) == 6


# -------------------------------------------------- default device -----


def test_new_entry_points_raise_without_cuda(monkeypatch, tree, tmp_path):
    from semantic_pyramid_for_image_generation_torch.cli import export_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (ft.main, ["--data", tree, "--save_dir", str(tmp_path / "s")]),
            (vgg16_infer.main, ["--data", tree]),
            (export_serving.main, ["--out", str(tmp_path / "a")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not os.listdir(tmp_path)


def test_finetune_object_exposes_its_parts(tree, tmp_path):
    args = ft.build_parser().parse_args(
        ["--device", "cpu", "--data", tree, "--image_size", str(IMG),
         "--vgg_width_factor", str(WIDTH), "--num_classes", "6",
         "--load_vgg16", "", "--save_dir", str(tmp_path / "s"),
         "--batch_size", "8", "--workers", "2"])
    run = ft.FineTune(args)
    assert isinstance(run.model, VGG16) and run.start_epoch == 0
    assert len(run.train_loader) == 2 and len(run.val_loader) == 3
    assert sum(p.numel() for p in run.model.parameters()) == sum(
        s.numel() for group in run.optimizer.param_groups
        for s in group["params"])
    assert run.config == _cfgs(6, "bfloat16")[0]
