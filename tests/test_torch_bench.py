"""The port's throughput lanes (semantic_pyramid_for_image_generation_torch/
bench.py) against the repository's root bench script, loaded through
importlib: its flags, its refusals, the default lane's state and the
attention check. The lanes' JSON lines are held in test_torch_bench_lanes.py.

Held, on the CPU at --channel_factor 8 --vgg_width_factor 8:
  * the parser takes every flag of the root script, with its default, plus
    --device (default cuda);
  * the default lane's 2 x --steps steps (the warm-up walk and the timed
    one) leave G, D, both Adam states and the step count bitwise equal to as
    many direct `make_train_step` calls from the same seeds;
  * --check-pallas passes with the plain attention (its CPU route), and a
    planted fault (the kernel's output scaled by 1 + 1e-2) makes it print
    FAIL and exit 1;
  * --no-pallas is refused; --device cuda raises before anything is built
    when there is no card;
  * the --trainer tree's size is the root script's formula.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch import bench
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_train_step,
)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = ["--channel_factor", "8", "--vgg_width_factor", "8", "--batch_size",
        "2", "--steps", "2", "--warmup", "1", "--device", "cpu"]


def _load_root_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_root_bench"] = module
    spec.loader.exec_module(module)
    return module


class _Captured(Exception):
    pass


def _root_parser(monkeypatch):
    """The root script's parser, captured at parse_args: no lane runs."""
    import argparse

    root = _load_root_bench()
    seen = []

    def capture(self, *args, **kwargs):
        seen.append(self)
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        root.main()
    monkeypatch.undo()
    return seen[0]


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_flags_are_the_root_scripts_plus_device(monkeypatch):
    root = _root_parser(monkeypatch)
    port = bench.build_parser()

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert options(port) - {"-h", "--help"} == \
        (options(root) - {"-h", "--help"}) | {"--device"}
    want = vars(root.parse_args([]))
    got = vars(port.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert (got["batch_size"], got["steps"], got["warmup"], got["dtype"]) == \
        (128, 8, 3, "bfloat16")


def test_default_lane_state_equals_direct_steps(capsys):
    args = bench.build_parser().parse_args(TINY)
    line, state = bench.scan_steps_lane(args, CPU)
    config = bench.train_config(args)
    want = init_train_state(config, CPU)
    step = make_train_step()
    batch = batch_to_device(
        synthetic_batch(config, 2, np.random.default_rng(0)), CPU)
    rng = torch.Generator(CPU).manual_seed(1)
    for _ in range(2 * args.steps):
        step(want, batch, rng)
    assert state.step == want.step == 4
    for net in ("generator", "discriminator"):
        got_sd = getattr(state, net).state_dict()
        for key, value in getattr(want, net).state_dict().items():
            assert torch.equal(got_sd[key], value), (net, key)
    for opt in ("g_optimizer", "d_optimizer"):
        got_opt = getattr(state, opt).state_dict()["state"]
        for i, slot in getattr(want, opt).state_dict()["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got_opt[i][k], slot[k]), (opt, i, k)
    assert _json_lines(capsys.readouterr().out) == [line]


def test_check_pallas_passes_with_the_plain_attention(capsys):
    assert bench.main(["--check-pallas", "--device", "cpu",
                       "--batch_size", "2"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "card: cpu"
    (line,) = _json_lines(out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert ": PASS {" in line["metric"] and line["vs_baseline"] == 1.0
    assert "batch 2" in line["metric"]
    assert line["unit"] == "max abs diff (kernel vs oracle, fp32 fwd+grads)"
    assert 0.0 <= line["value"] <= 1e-3


def test_check_pallas_fails_on_a_planted_fault(monkeypatch, capsys):
    class Scaled:
        @staticmethod
        def apply(q, k, v):
            return bench.pooled_kv_attention_plain(q, k, v) * (1 + 1e-2)

    monkeypatch.setattr(bench, "PooledKVAttentionFunction", Scaled)
    with pytest.raises(SystemExit) as exited:
        bench.main(["--check-pallas", "--device", "cpu"])
    assert exited.value.code == 1
    (line,) = _json_lines(capsys.readouterr().out)
    assert ": FAIL {" in line["metric"] and line["vs_baseline"] == 0.0


def test_no_pallas_is_refused(capsys):
    with pytest.raises(SystemExit) as exited:
        bench.main(["--no-pallas", "--device", "cpu"])
    assert exited.value.code == 2
    assert "--no-pallas" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_raises_without_a_card(monkeypatch):
    built = []
    for name in ("init_train_state", "make_models", "make_jpeg_tree",
                 "synthetic_batch"):
        monkeypatch.setattr(bench, name, lambda *a, **k: built.append(a))
    for argv in ([], ["--trainer"], ["--serving-artifact"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(argv)
    assert built == []


def test_trainer_tree_is_the_root_formula():
    source = (REPO / "bench.py").read_text()
    assert "per_class = max(16, -(-args.batch_size * args.steps // 4))" in \
        source
    for batch, steps in ((128, 8), (16, 2), (2, 2), (64, 3)):
        assert bench.trainer_per_class(batch, steps) == \
            max(16, -(-batch * steps // 4))
    assert bench.trainer_per_class(128, 8) == 256
