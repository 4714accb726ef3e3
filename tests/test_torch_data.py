"""The port's Places365 pipeline and half-pixel resize against the JAX
package's, on the same inputs.

Loader: a tiny tree of 32x32 images (RGB and one grayscale) written in a
temporary directory, as tests/test_data_pipeline.py builds it. The port's
`Places365` / `Places365Loader` must give the JAX package's batches bitwise:
images, labels and masks, with the numpy and the native mask schedules, the
compact (uint8) feed, a seeded `max_length` subset, and shard outputs that
concatenate to the global batch. Tolerance: none (bitwise); both sides run
the same numpy and the same native library.

Resize: `resize_bilinear_half_pixel` against `jax.image.resize(...,
antialias=False)` in fp32, at 256->299 and at the 320->299 downscale: 1e-5
absolute on inputs in [-1, 1] (two-tap interpolation, fp32 rounding).
"""

import fcntl
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.data import native as jax_native
from semantic_pyramid_for_image_generation_tpu.data.places365 import (
    Places365 as JaxPlaces365,
    Places365Loader as JaxPlaces365Loader,
)
from semantic_pyramid_for_image_generation_tpu.ops.resize import (
    resize_bilinear_half_pixel as jax_resize_half_pixel,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data import native
from semantic_pyramid_for_image_generation_torch.data.places365 import (
    Places365,
    Places365Loader,
)
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    resize_bilinear_half_pixel,
)

CFG = PyramidGANConfig(image_size=32).tiny()
JCFG = JaxConfig(image_size=32).tiny()


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("places")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        lines = []
        for cls in ("abbey", "airfield", "zoo"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(4):
                arr = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                if cls == "zoo" and i == 0:  # the grayscale branch
                    Image.fromarray(arr[:, :, 0], mode="L").save(d / f"{i}.png")
                else:
                    Image.fromarray(arr).save(d / f"{i}.png")
                lines.append(f"{split}/{cls}/{i}.png")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    assert native.native_available()
    assert jax_native_loaded()
    return str(root)


def jax_native_loaded(quiet_s: float = 1.0, limit_s: float = 60.0) -> bool:
    """Whether the JAX package's native library is loaded in this process,
    for the native mask cases (the port's own build is locked and atomic).
    The JAX package builds the library in place with `make`, unlocked, so
    this process may have opened it while another test process's linker
    was still writing it ("file too short") and kept `_load_failed`. Then
    the load is retried once, after the file has not changed for
    `quiet_s`. Port test processes take the port's build lock around the
    load, so they do not race each other's JAX builds."""
    lock_path = os.path.join(os.path.dirname(native.library_path()), "lock")
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if jax_native.native_available():
            return True
        path = jax_native._LIB_PATH
        deadline = time.monotonic() + limit_s
        while time.monotonic() < deadline and not (
                os.path.exists(path)
                and time.time() - os.path.getmtime(path) >= quiet_s):
            time.sleep(0.1)
        jax_native._load_failed = False
        jax_native.load_library()
        return jax_native.native_available()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("images", "labels"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert len(g["masks"]) == len(w["masks"]) == 7
        for gm, wm in zip(g["masks"], w["masks"]):
            assert gm.dtype == wm.dtype
            np.testing.assert_array_equal(gm, wm)


def test_index_and_labels_match_jax(dataset_root):
    ds = Places365(dataset_root, "train.txt", CFG)
    ref = JaxPlaces365(dataset_root, "train.txt", JCFG)
    assert ds.file_paths == ref.file_paths
    assert ds.label_dict == ref.label_dict == {"abbey": 0, "airfield": 1,
                                               "zoo": 2}
    sub = Places365(dataset_root, "val.txt", CFG, max_length=5, seed=7,
                    validation=True)
    ref_sub = JaxPlaces365(dataset_root, "val.txt", JCFG, max_length=5,
                           seed=7, validation=True)
    assert sub.file_paths == ref_sub.file_paths and len(sub) == 5


@pytest.mark.parametrize("use_native_masks", [False, True])
@pytest.mark.parametrize("compact_feed", [False, True])
@pytest.mark.parametrize("index,validation", [("train.txt", False),
                                              ("val.txt", True)])
def test_loader_batches_match_jax_bitwise(dataset_root, use_native_masks,
                                          compact_feed, index, validation):
    """Two epochs (the reshuffle and the per-epoch mask seeds) with a ragged
    final batch."""
    kw = dict(batch_size=5, num_workers=2, seed=3, drop_last=False,
              use_native_masks=use_native_masks, compact_feed=compact_feed)
    loader = Places365Loader(
        Places365(dataset_root, index, CFG, validation=validation), **kw)
    ref = JaxPlaces365Loader(
        JaxPlaces365(dataset_root, index, JCFG, validation=validation), **kw)
    assert loader.use_native_masks == use_native_masks
    for _ in range(2):
        got, want = list(loader), list(ref)
        assert [b["images"].shape[0] for b in got] == [5, 5, 2]
        _assert_batches_equal(got, want)
    if compact_feed:
        assert got[0]["images"].dtype == np.uint8


def test_native_masks_are_the_default_when_built(dataset_root):
    assert native.native_available()
    loader = Places365Loader(Places365(dataset_root, "train.txt", CFG),
                             batch_size=4, num_workers=2)
    assert loader.use_native_masks
    np.testing.assert_array_equal(
        native.normalize_image_m11(np.arange(48, dtype=np.uint8).reshape(
            4, 4, 3)),
        jax_native.normalize_image_m11(np.arange(48, dtype=np.uint8).reshape(
            4, 4, 3)))


@pytest.mark.parametrize("use_native_masks", [False, True])
def test_shards_concat_to_the_jax_global_batch(dataset_root, use_native_masks):
    kw = dict(batch_size=5, num_workers=2, seed=7, drop_last=False,
              use_native_masks=use_native_masks)
    ds = Places365(dataset_root, "train.txt", CFG)
    ref = JaxPlaces365Loader(JaxPlaces365(dataset_root, "train.txt", JCFG),
                             **kw)
    shards = [Places365Loader(ds, num_shards=2, shard_id=s, **kw)
              for s in range(2)]
    for _ in range(2):
        want = list(ref)
        parts = [list(s) for s in shards]
        got = [{"images": np.concatenate([a["images"], b["images"]]),
                "labels": np.concatenate([a["labels"], b["labels"]]),
                "masks": tuple(np.concatenate([am, bm]) for am, bm in
                               zip(a["masks"], b["masks"]))}
               for a, b in zip(*parts)]
        _assert_batches_equal(got, want)
    with pytest.raises(ValueError):
        Places365Loader(ds, batch_size=4, num_shards=2, shard_id=2)


def test_shard_rows_place_each_shard_in_its_global_batch(dataset_root):
    """A shard's batch says where its rows sit in the global batch (the
    Trainer draws a validation batch's latents for the global batch); an
    unsharded batch has no `shard_rows`. A shard that gets no row of the
    ragged last batch gets that batch's last row, padded, with `num_valid`
    0: every shard runs every batch (a generate over sharded state is a
    collective)."""
    ds = Places365(dataset_root, "train.txt", CFG)
    kw = dict(batch_size=5, num_workers=2, seed=7, drop_last=False)
    assert all("shard_rows" not in b for b in Places365Loader(ds, **kw))
    padded = 0
    for shards in (2, 3, 4):
        parts = [list(Places365Loader(ds, num_shards=shards, shard_id=s, **kw))
                 for s in range(shards)]
        totals = [min(5, len(ds) - 5 * i) for i in range(-(-len(ds) // 5))]
        for s, part in enumerate(parts):
            want = [np.array_split(np.arange(n), shards)[s] for n in totals]
            valid = [len(w) for w in want]
            want = [(int(w[0]), int(w[-1]) + 1, n) if len(w) else (n - 1, n, n)
                    for w, n in zip(want, totals)]
            got = [tuple(int(v) for v in b["shard_rows"]) for b in part]
            assert got == want
            assert [b["images"].shape[0] for b in part] == \
                [stop - start for start, stop, _ in want]
            assert [int(b.get("num_valid", b["images"].shape[0]))
                    for b in part] == valid
            padded += valid.count(0)
    assert padded  # some shard got no row of a ragged batch


def test_abandoned_iterator_stops_its_producer(dataset_root):
    import threading
    import time

    loader = Places365Loader(Places365(dataset_root, "train.txt", CFG),
                             batch_size=2, num_workers=2, prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_more_class_folders_than_classes_raises(dataset_root):
    import dataclasses

    with pytest.raises(ValueError, match="alias"):
        Places365(dataset_root, "train.txt",
                  dataclasses.replace(CFG, num_classes=2))


@pytest.mark.parametrize("size,out", [(256, 299), (320, 299), (64, 299)])
def test_half_pixel_resize_matches_jax(size, out):
    x = np.random.default_rng(size).uniform(
        -1, 1, (2, size, size + 8, 3)).astype(np.float32)
    want = np.asarray(jax_resize_half_pixel(jnp.asarray(x), out, out))
    got = resize_bilinear_half_pixel(torch.from_numpy(x), out, out)
    assert got.shape == (2, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
