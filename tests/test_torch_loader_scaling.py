"""The port's loader scaling bench (semantic_pyramid_for_image_generation_
torch/scripts/loader_scaling_bench.py) against the repository's
scripts/loader_scaling_bench.py, loaded through importlib.

Held:
  * the flags: the port's parser takes the JAX script's flags plus
    --device;
  * the output: each row's keys equal the JAX script's, and the summary's
    keys equal its keys plus `card` and `mask_route`; both scripts run on
    8 JPEGs at batch 4 and 1 worker (the port's device rate at the tiny
    config on the CPU, one timed step);
  * the device rate is the port's measurement: finite, positive, and never
    the JAX script's TPU constant 278.3;
  * `mask_route` says which mask route the loader took:
    `native_available()`;
  * the loader the bench times: its first batch equals the JAX package's
    `Places365Loader`'s over the same tree and seed, bitwise (images,
    labels, masks), in the compact and the float feed, with the numpy and
    the native mask route given to both loaders.
`--device cuda` raises on a host without a card before it builds anything.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.data import native as jax_native
from semantic_pyramid_for_image_generation_tpu.data.places365 import (
    Places365 as JaxPlaces365,
    Places365Loader as JaxPlaces365Loader,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data import native
from semantic_pyramid_for_image_generation_torch.scripts import (
    loader_scaling_bench as bench,
)
from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
    make_jpeg_tree,
)
from test_torch_data import jax_native_loaded

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--workers", "1", "--images", "8", "--batch", "4"]
JAX_CONSTANT = 278.3


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_loader_scaling_bench",
        REPO / "scripts" / "loader_scaling_bench.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_loader_scaling_bench"] = module
    spec.loader.exec_module(module)
    return module


jax_bench = _load_jax_bench()


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def outputs():
    """(JAX lines, port lines, port summary) on ARGV."""
    import contextlib
    import io

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", ["loader_scaling_bench.py"] + ARGV)
        jax_bench.main()
    jax_lines = _json_lines(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, summary = bench.run(
            bench.build_parser().parse_args(ARGV + ["--device", "cpu"]),
            PyramidGANConfig().tiny(), warmup=1, steps=1)
    return jax_lines, _json_lines(out.getvalue()), summary


def test_flags_are_the_jax_scripts_plus_device(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["loader_scaling_bench.py", "--help"])
    with pytest.raises(SystemExit):
        jax_bench.main()
    jax_flags = set(re.findall(r"--\w+", capsys.readouterr().out))
    port = {a for action in bench.build_parser()._actions
            for a in action.option_strings if a.startswith("--")}
    assert port - {"--help"} == (jax_flags - {"--help"}) | {"--device"}
    args = bench.build_parser().parse_args([])
    assert (args.workers, args.batch, args.images, args.float_feed,
            args.device) == ("1,2,4,8", 64, 512, False, "cuda")


def test_rows_and_summary_keys_match_the_jax_script(outputs):
    jax_lines, port_lines, summary = outputs
    assert len(jax_lines) == len(port_lines) == 2
    assert set(port_lines[0]) == set(jax_lines[0])
    assert port_lines[0]["num_workers"] == jax_lines[0]["num_workers"] == 1
    assert set(port_lines[1]) == set(jax_lines[1]) | {"card", "mask_route"}
    assert port_lines[1] == summary
    assert summary["card"] == "cpu"
    assert summary["feed"] == jax_lines[1]["feed"] == "uint8-compact"
    assert summary["peak_workers"] == 1
    assert summary["decode_speedup_at_peak"] == 1.0


def test_summary_carries_the_measured_rate(outputs):
    jax_lines, port_lines, summary = outputs
    assert jax_lines[1]["device_rate_to_beat_img_per_s"] == JAX_CONSTANT
    rate = summary["device_rate_to_beat_img_per_s"]
    assert np.isfinite(rate) and rate > 0 and rate != JAX_CONSTANT
    assert str(JAX_CONSTANT) not in json.dumps(port_lines)


def test_mask_route_is_the_loaders(outputs):
    assert outputs[2]["mask_route"] == (
        "native" if native.native_available() else "numpy")


def test_device_step_rate_at_tiny_on_the_cpu():
    rate = bench.device_step_rate(PyramidGANConfig().tiny(), 2,
                                  torch.device("cpu"), dtype="float32",
                                  warmup=1, steps=2)
    assert np.isfinite(rate) and rate > 0


def _native_route_ready() -> None:
    """Both packages' native libraries loaded in this process: the port's
    (its locked build), then the JAX package's, retried once if this
    process opened it half-written (test_torch_data.py::jax_native_loaded)."""
    assert native.native_available(), (
        "native route: the port's library did not build")
    assert jax_native_loaded(), (
        "native route: the JAX package's library failed to load, twice")


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "float"])
@pytest.mark.parametrize("route", ["numpy", "native"])
def test_first_batch_matches_the_jax_loader(tmp_path, route, compact):
    """Each loader is told its mask route, so the numpy cases need no
    build and the native cases cannot fall back to numpy on one side."""
    use_native = route == "native"
    if use_native:
        _native_route_ready()
    root = make_jpeg_tree(str(tmp_path), per_class=2, classes=4)
    loader = bench.make_loader(root, PyramidGANConfig(), 4, 2, compact,
                               use_native_masks=use_native)
    want = next(iter(JaxPlaces365Loader(
        JaxPlaces365(root, "train.txt", JaxConfig()), batch_size=4,
        num_workers=2, prefetch=2, compact_feed=compact,
        use_native_masks=use_native)))
    got = next(iter(loader))
    assert loader.use_native_masks is use_native
    assert got["images"].dtype == (np.uint8 if compact else np.float32)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert len(got["masks"]) == len(want["masks"]) == 7
    for g, w in zip(got["masks"], want["masks"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_raises_without_a_card(monkeypatch):
    made = []
    monkeypatch.setattr(bench, "make_jpeg_tree",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--images", "8"])
    assert made == []
