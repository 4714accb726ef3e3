"""The port's ImageFolder pipeline against the JAX package's, on a tree of
JPEG and PNG files of several sizes in tmp_path.

Tolerance: none. The two are the same numpy and PIL code, so every batch of
2 epochs must be equal bit for bit (images, labels, dtypes, shapes), with
the (seed, epoch) shuffle and flips and without them.
"""

import numpy as np
import pytest
from PIL import Image

from semantic_pyramid_for_image_generation_tpu.data.image_folder import (
    ImageFolder as JaxImageFolder,
)
from semantic_pyramid_for_image_generation_tpu.data.image_folder import (
    ImageFolderLoader as JaxImageFolderLoader,
)
from semantic_pyramid_for_image_generation_torch.data.image_folder import (
    ImageFolder,
    ImageFolderLoader,
)

IMG = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 classes of 5 images: JPEG and PNG, 32x32 and other sizes (resized),
    grey and RGB, and a file that is not an image."""
    root = tmp_path_factory.mktemp("image_folder")
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("b_beach", "a_forest", "c_canyon")):
        (root / cls).mkdir()
        for i in range(5):
            h, w = (IMG, IMG) if i % 2 else (40 + 4 * c, 28 + 2 * i)
            pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img = Image.fromarray(pixels)
            if i == 3:
                img = img.convert("L")
            img.save(root / cls / f"{i}.{'jpg' if (i + c) % 2 else 'png'}")
        (root / cls / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, random_flip=True, drop_last=True),
    dict(shuffle=False, random_flip=False, drop_last=False)],
    ids=["shuffle-flip-drop_last", "in-order"])
def test_batches_equal_the_jax_loader_bitwise(tree, kw):
    port_ds, jax_ds = ImageFolder(tree, IMG), JaxImageFolder(tree, IMG)
    assert port_ds.samples == jax_ds.samples and len(port_ds) == 15
    assert port_ds.class_to_idx == jax_ds.class_to_idx == {
        "a_forest": 0, "b_beach": 1, "c_canyon": 2}
    port = ImageFolderLoader(port_ds, 4, num_workers=2, seed=3, **kw)
    ref = JaxImageFolderLoader(jax_ds, 4, num_workers=2, seed=3, **kw)
    assert len(port) == len(ref) == (3 if kw["drop_last"] else 4)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype == np.float32
            assert gl.dtype == wl.dtype == np.int32
            assert gi.shape[1:] == (IMG, IMG, 3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert port.epoch == ref.epoch == 2


def test_a_resumed_epoch_replays_the_order(tree):
    """Setting `epoch` (as --resume does) yields that epoch's batches."""
    straight = ImageFolderLoader(ImageFolder(tree, IMG), 4, num_workers=2)
    first, second = list(straight), list(straight)
    resumed = ImageFolderLoader(ImageFolder(tree, IMG), 4, num_workers=2)
    resumed.epoch = 1
    again = list(resumed)
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(first, second))
    for (gi, gl), (wi, wl) in zip(again, second):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
