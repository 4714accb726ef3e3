"""The one generator of the benchmark's inputs. A traffic mix is a JSON file
of parameters under `traffic/`; everything here is drawn from the run's seed
on the device, in a few large calls, and copied to the host where the
program takes host data.

Two kinds of input, chosen by the parameters a mix gives:
  * `pool` training batches of the GAN in the loader's compact form: uint8
    (B, H, W, 3) images, uint8 masks of the training schedule (1-4
    rectangles when a level is spatially masked), one-hot float32 labels;
  * `pool` fine-tune batches in the ImageFolder loader's form: float32
    ImageNet-normalized (B, H, W, 3) images and int32 labels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    words = np.random.SeedSequence((seed, stream)).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((seed, stream)))


def pyramid_shapes(config: dict) -> List[tuple]:
    """Per-sample mask shapes, shallow -> deep: five (h, w, 1), fc7, fc8."""
    s = config["image_size"]
    vf = config.get("vgg_width_factor", 1)
    return ([(s >> (i + 1), s >> (i + 1), 1) for i in range(5)]
            + [(4096 // vf,), (config["num_classes"],)])


def training_masks(config: dict, rows: int, p_spatial: float,
                   rng: np.random.Generator) -> List[np.ndarray]:
    """The training schedule's masks for `rows` samples: a level drawn from
    the seven, the two deepest twice as likely; ones at it, zeros deeper;
    shallower levels zero, or with probability `p_spatial` (interior levels)
    one mask of rectangles holes drawn at the next-shallower level's
    resolution and repeated up to each shallower one."""
    shapes = pyramid_shapes(config)[::-1]  # deep -> shallow
    out = [np.zeros((rows,) + s, np.uint8) for s in shapes]
    stages = rng.choice(list(range(7)) + [0, 1], size=rows)
    spatial = (rng.random(rows) < p_spatial) & (stages > 0) & (stages < 6)
    for r in range(rows):
        stage = int(stages[r])
        out[stage][r] = 1
        if not spatial[r]:
            continue
        h = shapes[stage + 1][0]
        base = np.ones((h, h), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            size = rng.integers(max(1, min(8, h // 2)), h + 1, size=2)
            r0, c0 = (int(rng.integers(0, h - n + 1)) for n in size)
            base[r0:r0 + size[0], c0:c0 + size[1]] = 0
        for level in range(stage + 1, 7):
            k = shapes[level][0] // h
            out[level][r, :, :, 0] = np.kron(base, np.ones((k, k), np.uint8))
    return out[::-1]


def gan_batches(config: dict, traffic: dict, seed: int,
                device: torch.device) -> List[Dict[str, object]]:
    """`pool` batches of `batch` rows, every row different."""
    pool, rows, s = traffic["pool"], traffic["batch"], config["image_size"]
    images = torch.randint(0, 256, (pool, rows, s, s, 3), dtype=torch.uint8,
                           generator=_generator(seed, 1, device),
                           device=device).cpu().numpy()
    rng = numpy_rng(seed, 2)
    classes = config["num_classes"]
    batches = []
    for i in range(pool):
        labels = np.zeros((rows, classes), np.float32)
        labels[np.arange(rows), rng.integers(0, classes, rows)] = 1.0
        masks = training_masks(config, rows, traffic["p_spatial_mask"], rng)
        batches.append({"images": images[i], "labels": labels,
                        "masks": tuple(masks)})
    return batches


def finetune_batches(config: dict, traffic: dict, seed: int,
                     device: torch.device) -> List[tuple]:
    """`pool` (images, labels) batches as the ImageFolder loader yields
    them: [0, 1] pixels ImageNet-normalized, float32 NHWC."""
    pool, rows, s = traffic["pool"], traffic["batch"], config["image_size"]
    g = _generator(seed, 3, device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    batches = []
    for _ in range(pool):
        x = (torch.rand((rows, s, s, 3), generator=g, device=device)
             - mean) / std
        labels = torch.randint(0, config["num_classes"], (rows,), generator=g,
                               device=device, dtype=torch.int32)
        batches.append((x.cpu().numpy(), labels.cpu().numpy()))
    return batches
