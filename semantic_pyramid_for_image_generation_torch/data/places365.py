"""Places365 input pipeline, a copy of the JAX package's data/places365.py:
the same seed gives the same numpy batches.

Index parsing, host-side decode and normalization, a per-sample mask draw,
and batching into the train step's batch dict (numpy; the Trainer moves it
to the card with `train/step.py::batch_to_device`):
  * index file lines are `<split>/<class>/<file>`; label = second path
    component, class ids in sorted-path first-seen order. Every line is read
    (the reference's pd.read_csv header quirk, which drops the first one, is
    `drop_first_index_line=True`).
  * images decode to [0, 1], grayscale broadcasts to RGB, then per-image
    min-max normalization to [-1, 1], NHWC.
  * `max_length` draws a seeded random subset.
  * each sample carries a fresh mask draw (training or validation schedule),
    seeded per (seed, epoch, index); the native batched kernel, when built,
    draws a batch's masks at once, seeded per (seed, epoch * n_batches + b).

A thread pool decodes and masks samples concurrently (PIL releases the GIL
in the decoder) while a bounded prefetch queue keeps whole batches ahead of
the consumer.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data import native
from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule


class Places365:
    """Index + per-sample loader."""

    def __init__(
        self,
        path_to_index_file: str,
        index_file_name: str = "train.txt",
        config: PyramidGANConfig = PyramidGANConfig(),
        max_length: Optional[int] = None,
        validation: bool = False,
        seed: int = 0,
        drop_first_index_line: bool = False,
    ) -> None:
        self.root = path_to_index_file
        self.config = config
        self.validation = validation
        self.schedule = MaskSchedule(config)
        with open(os.path.join(path_to_index_file, index_file_name)) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if drop_first_index_line:  # bug-compat with pd.read_csv header loss
            lines = lines[1:]
        self.file_paths: List[str] = sorted(lines)
        self.label_dict: Dict[str, int] = {}
        for file_path in self.file_paths:
            folder = file_path.split("/")[1]
            if folder not in self.label_dict:
                self.label_dict[folder] = len(self.label_dict)
        if len(self.label_dict) > self.config.num_classes:
            raise ValueError(
                f"index file names {len(self.label_dict)} class folders but "
                f"config.num_classes={self.config.num_classes}; labels would "
                "alias — raise num_classes or filter the index file")
        if max_length is not None and max_length < len(self.file_paths):
            rng = np.random.default_rng(seed)
            self.file_paths = list(
                rng.choice(self.file_paths, max_length, replace=False))

    def __len__(self) -> int:
        return len(self.file_paths)

    def _load_image(self, path: str, raw_uint8: bool = False) -> np.ndarray:
        from PIL import Image

        size = self.config.image_size
        with Image.open(os.path.join(self.root, path)) as img:
            if raw_uint8 and img.mode not in ("RGB", "L", "RGBA"):
                # compact-feed batches must be homogeneously uint8: a 16/32-bit
                # source would fall through to the float path and np.stack
                # would promote the whole batch to float32
                img = img.convert("RGB")
            if img.size != (size, size):
                img = img.resize((size, size), Image.BILINEAR)
            raw = np.asarray(img)
        if raw_uint8 and raw.dtype == np.uint8:
            # compact feed: uint8 HW3; the train step min-max normalizes on
            # the device (ensure_m11_images), the /255 cancels in the min-max
            if raw.ndim == 2:
                raw = raw[:, :, None]
            if raw.shape[-1] == 1:
                raw = np.repeat(raw, 3, axis=-1)
            if raw.shape[-1] == 4:
                raw = raw[:, :, :3]
            return raw
        if raw.dtype == np.uint8:
            # native kernel: uint8 HWC -> float32 HW3 in [-1, 1]
            out = native.normalize_image_m11(raw)
            if out is not None:
                return out
        arr = raw.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        if arr.shape[-1] == 4:
            arr = arr[:, :, :3]
        mn, mx = arr.min(), arr.max()
        return 2.0 * (arr - mn) / max(mx - mn, 1e-12) - 1.0

    def sample(self, index: int, rng: np.random.Generator,
               with_masks: bool = True, raw_uint8: bool = False):
        path = self.file_paths[index]
        image = self._load_image(path, raw_uint8=raw_uint8)
        label = np.zeros(self.config.num_classes, dtype=np.float32)
        # in range by construction: __init__ raises if folders > num_classes
        label[self.label_dict[path.split("/")[1]]] = 1.0
        if not with_masks:  # masks come from the native batched kernel
            return image, label, None
        if self.validation:
            masks = self.schedule.validation_masks(rng)
        else:
            masks = self.schedule.training_masks(rng)
        return image, label, masks


def shard_of(n: int, num_shards: int, shard_id: int) -> Tuple[np.ndarray, int]:
    """(rows, num_valid): shard `shard_id`'s contiguous rows of a global
    batch of `n` (np.array_split's) and how many of them count. A shard
    that gets no row of a ragged batch (n < num_shards) takes the batch's
    last row as a padded row that does not count (num_valid 0), so every
    shard runs every batch: over sharded state each generate is a
    collective (parallel/mesh.py), as the JAX package pads a batch to its
    mesh."""
    rows = np.array_split(np.arange(n), num_shards)[shard_id]
    if len(rows) == 0:
        return np.arange(n)[-1:], 0
    return rows, len(rows)


class Places365Loader:
    """Shuffled, threaded, prefetching batch iterator.

    Emits the train step's batch dict as numpy arrays:
        {"images": (B,H,W,3) f32, "labels": (B,N) f32, "masks": 7-tuple}.
    """

    def __init__(
        self,
        dataset: Places365,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        use_native_masks: Optional[bool] = None,
        compact_feed: bool = False,
        num_shards: int = 1,
        shard_id: int = 0,
    ) -> None:
        """`num_shards`/`shard_id`: `batch_size` stays the global batch size;
        shard s decodes only its contiguous slice of every global batch, and
        the shuffle and mask draws are seeded identically on all shards, so
        concatenating the shard outputs reproduces the unsharded loader
        bit for bit. A shard's batch also holds `shard_rows`, (start, stop,
        total) of its rows in the global batch, on the host; a shard that
        gets no row of a ragged last batch gets a padded row and
        `num_valid` 0 (`shard_of`).
        `use_native_masks=None` takes the native batched mask kernel when
        the library builds, else the numpy schedule."""
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        # compact_feed: uint8 images + uint8 binary masks, ~4x fewer
        # host->device bytes; the train step normalizes and casts on device
        self.compact_feed = compact_feed
        if use_native_masks is None:
            use_native_masks = native.native_available()
        self.use_native_masks = use_native_masks

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, samples, native_masks=None) -> Dict[str, Any]:
        images = np.stack([s[0] for s in samples])
        labels = np.stack([s[1] for s in samples])
        if native_masks is not None:
            masks = native_masks
        else:
            masks = self.dataset.schedule.batch([s[2] for s in samples])
        if self.compact_feed:  # masks are binary; uint8 transfer is lossless
            masks = [m.astype(np.uint8) for m in masks]
        return {"images": images, "labels": labels, "masks": tuple(masks)}

    def _native_masks(self, batch: int, batch_index: int, n_batches: int):
        """Batched mask schedule via the C++ kernel; None -> the per-sample
        numpy schedule. Seeded per (loader seed, epoch, batch index)."""
        if not self.use_native_masks:
            return None
        return native.generate_masks_batch(
            self.dataset.config, batch, seed=self.seed,
            epoch=self.epoch * max(n_batches, 1) + batch_index,
            validation=self.dataset.validation)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        epoch_rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        if self.shuffle:
            epoch_rng.shuffle(order)
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # stop-aware bounded put: an abandoned iterator sets `stop`, and a
            # plain blocking put on the full queue would leak this thread,
            # its worker pool and the prefetched batches
            while True:
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                    # masks for the global batch (seeded identically on every
                    # shard), then row-sliced, so shard concat == unsharded
                    native_masks = self._native_masks(len(idx), b, n_batches)
                    shard_rows, num_valid = None, None
                    if self.num_shards > 1:
                        rows, num_valid = shard_of(len(idx), self.num_shards,
                                                   self.shard_id)
                        shard_rows = np.array([rows[0], rows[-1] + 1, len(idx)])
                        idx = idx[rows]
                        if native_masks is not None:
                            native_masks = [m[rows] for m in native_masks]
                    rngs = [np.random.default_rng((self.seed, self.epoch, int(i)))
                            for i in idx]
                    samples = list(pool.map(
                        self.dataset.sample, [int(i) for i in idx], rngs,
                        [native_masks is None] * len(idx),
                        [self.compact_feed] * len(idx)))
                    batch = self._collate(samples, native_masks)
                    if shard_rows is not None:
                        batch["shard_rows"] = shard_rows
                    if num_valid == 0:
                        batch["num_valid"] = np.int64(0)
                    if not put_or_stop(batch):
                        return
            put_or_stop(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
