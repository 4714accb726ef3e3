"""Each of the port's throughput lanes (semantic_pyramid_for_image_generation
_torch/bench.py) prints the root bench script's one JSON line, on the CPU at
--channel_factor 8 --vgg_width_factor 8, batch 2, --steps 2 --warmup 1.

Held per lane: the card line first ("card: cpu"; --trainer is called as
its lane function), then exactly one JSON line with the root script's
four keys and unit; the value finite and positive; `vs_baseline` the
value over the V100 anchor 600000 / 86400 = 6.944... (within the 0.01 of
rounding both to 2 places); the metric text opening with the root lane's
own text, read from the root script's source.
--trainer runs on a tree of 2 JPEGs per class here (the root formula gives
16: 64 CPU steps); its formula is held in test_torch_bench.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch import bench

REPO = Path(__file__).resolve().parents[1]
TINY = ["--channel_factor", "8", "--vgg_width_factor", "8", "--batch_size",
        "2", "--steps", "2", "--warmup", "1", "--device", "cpu"]
ANCHOR = 600_000 / 86_400
# lane flag -> the opening of its metric, which is the root lane's text
OPENINGS = {
    "": "images/sec/chip, 256x256 fused G/D train step, ",
    "--per-step": "images/sec/chip, 256x256 fused G/D train step",
    "--trainer": "images/sec/chip, 256x256 production Trainer.train "
                 "(host-fed, log_every=",
    "--host-pipeline": "images/sec/chip, 256x256 host-fed (",
    "--serving": "images/sec/chip, 256x256 serving generate (VGG pyramid "
                 "+ G eval fwd, batch ",
    "--serving-artifact": "images/sec/chip, 256x256 serving generate via ",
    "--vgg-finetune": "images/sec/chip, 256x256 VGG16 fine-tune step (fwd + "
                      "CE + Adam, cli/vgg16_finetune.py)",
}


def _root_source() -> str:
    """The root script's text with its string literals' line breaks joined."""
    return "".join(part.strip().strip('f"') for part in
                   (REPO / "bench.py").read_text().splitlines())


@pytest.mark.parametrize("lane", list(OPENINGS), ids=lambda f: f or "default")
def test_lane_prints_the_root_line(lane, capsys):
    if lane == "--trainer":  # the lane itself: main() would take 16
        bench.trainer_lane(bench.build_parser().parse_args(TINY),
                           torch.device("cpu"), per_class=2)
        out = capsys.readouterr().out
    else:
        assert bench.main(TINY + ([lane] if lane else [])) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[0] == "card: cpu"
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    (line,) = lines
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["unit"] == "images/sec/chip"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / ANCHOR,
                                                abs=0.011)
    opening = OPENINGS[lane]
    assert line["metric"].startswith(opening)
    assert opening.replace(" ", "") in _root_source().replace(" ", "")
    if lane in ("--serving", "--serving-artifact"):
        assert "batch 2; " in line["metric"] and " ms/call" in line["metric"]
    if lane == "--serving-artifact":
        assert " KB program, external weights" in line["metric"]
    if lane == "--host-pipeline":
        assert "uint8 feed, JPEG decode + " in line["metric"]
