"""The phase spans of the port's train loop and train steps
(utils/profiling.py::span), on the CPU at tiny() widths in fp32.

  * With no profiler recording, `span` enters no `record_function`: neither
    alone nor on a GAN or fine-tune step's path (record_function patched to
    raise). It reads the profiler's flag at each call.
  * Under a CPU profiler, two steps of `Trainer.train_step` hold every span
    of the GAN step once per step: the loop's `sp:loop.rng` and
    `sp:loop.to_device` before and outside `sp:step`, the step's phases
    inside it in their order. The same for two fine-tune steps built from
    the fine-tune CLI's `batch_to_device`, `dropout_generator` and
    `make_finetune_step`. The metric fetches of `Trainer._flush_metrics` and
    of the fine-tune CLI's `train_epoch` run under `sp:loop.fetch_metrics`.
  * The losses and the parameters after two steps are bitwise the same
    with the profiler on and off.
  * `Trainer.profile_steps`'s chrome trace holds the spans.
"""

import json
import types
import warnings

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch.cli import vgg16_finetune as ft
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.train.loop import Trainer
from semantic_pyramid_for_image_generation_torch.utils.profiling import (
    SPAN_PREFIX,
    span,
)

CFG = PyramidGANConfig().tiny()
FT_CFG = PyramidGANConfig(vgg_width_factor=16, image_size=32, num_classes=10)
CPU = torch.device("cpu")
LR = 1e-4
LOOP = ["sp:loop.rng", "sp:loop.to_device"]
GAN_PHASES = ["sp:step.inputs", "sp:step.pyramid.forward",
              "sp:step.d_phase.forward", "sp:step.d_phase.backward",
              "sp:step.d_phase.adam", "sp:step.g_phase.forward",
              "sp:step.g_phase.backward", "sp:step.g_phase.adam"]
FT_PHASES = ["sp:step.forward", "sp:step.backward", "sp:step.adam"]


def _trainer(tmp_path, seed=3):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        return Trainer(CFG, [], lr=LR, device=CPU,
                       save_data_path=str(tmp_path), allow_random_fid=True,
                       write_grids=False, seed=seed)


def _gan_batches(n=2):
    rng = np.random.default_rng(7)
    return [synthetic_batch(CFG, 2, rng) for _ in range(n)]


def _finetune(seed=0):
    model = VGG16(FT_CFG, return_output=True)
    model.initialize(torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    optimizer = ft.make_optimizer(model, LR)
    return model, optimizer, ft.make_finetune_step(model, optimizer)


def _ft_batches(n=2):
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((3, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 3).astype(np.int32)) for _ in range(n)]


def _gan_steps(trainer, batches):
    return [trainer.train_step(b) for b in batches]


def _ft_steps(step, batches):
    out = []
    for i, (images, labels) in enumerate(batches):
        x, y = ft.batch_to_device(images, labels, CPU)
        out.append(step(x, y, ft.dropout_generator(0, i, CPU)))
    return out


def _profiled(fn, tmp_path):
    """fn() under a CPU profiler; (its result, the trace's sp: spans as
    (name, start, end) in time order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, _spans(path)


def _spans(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(SPAN_PREFIX))


def _by_step(spans):
    """[(the spans before the step, outside any step; the spans inside it)]
    per `sp:step`, in time order."""
    spans = sorted(spans, key=lambda s: s[1])
    steps = [s for s in spans if s[0] == "sp:step"]
    out, last = [], -np.inf
    for _, start, end in steps:
        before = [n for n, s, e in spans if last <= s and e <= start]
        inside = [n for n, s, e in spans
                  if start <= s and e <= end and n != "sp:step"]
        out.append((before, inside))
        last = end
    return out


@pytest.mark.parametrize("path", ["span", "gan_step", "finetune_step"])
def test_no_record_function_without_a_profiler(path, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    if path == "span":
        with span("loop.rng") as inside:
            assert inside is None
        assert span("a") is span("b")  # one shared no-op context
    elif path == "gan_step":
        trainer = _trainer(tmp_path)
        metrics = _gan_steps(trainer, _gan_batches(1))[0]
        trainer._flush_metrics([(metrics, 2, 0)])
    else:
        _ft_steps(_finetune()[2], _ft_batches(1))


def test_span_reads_the_flag_at_each_call(monkeypatch):
    entered = []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with span("step.adam"):
        pass
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    with span("step.forward"):
        pass
    assert entered == ["sp:step.adam"]


def test_prefix_is_apart_from_the_benchmark_and_the_ops():
    for other in ("bench:", "aten::", "spig::"):
        assert not SPAN_PREFIX.startswith(other)
        assert not other.startswith(SPAN_PREFIX)


def test_gan_spans_once_per_step_in_order(tmp_path):
    trainer = _trainer(tmp_path)
    _, spans = _profiled(lambda: _gan_steps(trainer, _gan_batches()),
                         tmp_path)
    steps = _by_step(spans)
    assert len(steps) == 2
    for before, inside in steps:
        assert before == LOOP
        assert inside == GAN_PHASES
    names = [n for n, _, _ in spans]
    assert sorted(set(names)) == sorted(LOOP + GAN_PHASES + ["sp:step"])
    assert all(names.count(n) == 2 for n in set(names))


def test_finetune_spans_once_per_step_in_order(tmp_path):
    step = _finetune()[2]
    _, spans = _profiled(lambda: _ft_steps(step, _ft_batches()), tmp_path)
    steps = _by_step(spans)
    assert len(steps) == 2
    for before, inside in steps:
        # the CLI copies the batch, then draws the step's dropout generator
        assert before == ["sp:loop.to_device", "sp:loop.rng"]
        assert inside == FT_PHASES
    assert len(spans) == 2 * (2 + 1 + len(FT_PHASES))


@pytest.mark.parametrize("work", ["gan", "finetune"])
def test_profiler_leaves_the_numbers_bitwise(work, tmp_path):
    runs = []
    for profiled in (False, True):
        if work == "gan":
            trainer = _trainer(tmp_path / str(profiled))
            state = trainer.state
            fn = lambda: _gan_steps(trainer, _gan_batches())  # noqa: E731
            modules = (state.generator, state.discriminator)
        else:
            model, _, step = _finetune()
            fn = lambda: _ft_steps(step, _ft_batches())  # noqa: E731
            modules = (model,)
        out = _profiled(fn, tmp_path)[0] if profiled else fn()
        runs.append((out, [{k: v.clone() for k, v in m.state_dict().items()}
                           for m in modules]))
    (out_a, params_a), (out_b, params_b) = runs
    for a, b in zip(out_a, out_b):
        pairs = ([(a[k], b[k]) for k in a] if isinstance(a, dict)
                 else list(zip(a, b)))
        assert all(torch.equal(x, y) for x, y in pairs)
    for a, b in zip(params_a, params_b):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("loop", ["trainer", "finetune_cli"])
def test_metric_fetches_run_under_their_span(loop, tmp_path, capsys):
    if loop == "trainer":
        trainer = _trainer(tmp_path)
        pending = [(m, 2 * (i + 1), 0) for i, m in
                   enumerate(_gan_steps(trainer, _gan_batches()))]
        _, spans = _profiled(lambda: trainer._flush_metrics(pending),
                             tmp_path)
        want = 1
    else:
        model, optimizer, step = _finetune()
        cli = types.SimpleNamespace(
            args=types.SimpleNamespace(lr=LR, max_steps=None, batch_size=3),
            optimizer=optimizer, train_loader=_ft_batches(2),
            train_step=step, device=CPU)
        _, spans = _profiled(lambda: ft.FineTune.train_epoch(cli, 0),
                             tmp_path)
        want = 1  # LOG_EVERY steps apart: the first step's alone
        assert "epoch 0 it 0" in capsys.readouterr().out
    fetches = [s for s in spans if s[0] == "sp:loop.fetch_metrics"]
    assert len(fetches) == want


def test_profile_steps_trace_holds_the_spans(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.profile_steps(_gan_batches(1)[0], str(tmp_path / "trace"),
                          steps=1)
    names = [n for n, _, _ in _spans(tmp_path / "trace" / "trace.json")]
    assert sorted(names) == sorted(LOOP + GAN_PHASES + ["sp:step"])
