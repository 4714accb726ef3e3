"""A synthetic Places365-format JPEG tree for the training entry points.

    <root>/train/class_CC/III.jpg, <root>/train.txt
    <root>/val/class_CC/III.jpg,   <root>/val.txt   (when val_per_class > 0)

Each image is a 16x16x3 uint8 draw from np.random.default_rng(0), resized
bilinearly to image_size and saved at JPEG quality 88 (low-frequency
content, so decoding costs what a photograph's does); the train split is
drawn first, class by class, then the val split. The index files hold
`<split>/class_CC/III.jpg` lines. The repository's scripts/long_run.py
(train and val) and bench.py (train only) write the same files.
"""

from __future__ import annotations

import os

import numpy as np


def make_jpeg_tree(root: str, image_size: int = 256, per_class: int = 64,
                   classes: int = 4, val_per_class: int = 0) -> str:
    """Write the tree under `root` and return `root`."""
    from PIL import Image

    rng = np.random.default_rng(0)
    splits = [("train", per_class)]
    if val_per_class > 0:
        splits.append(("val", val_per_class))
    for split, per in splits:
        lines = []
        for c in range(classes):
            d = os.path.join(root, split, f"class_{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per):
                base = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
                img = Image.fromarray(base).resize(
                    (image_size, image_size), Image.BILINEAR)
                img.save(os.path.join(d, f"{i:03d}.jpg"), quality=88)
                lines.append(f"{split}/class_{c:02d}/{i:03d}.jpg")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root
