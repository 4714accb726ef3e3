"""ImageFolder-style classification pipeline for the VGG-16 fine-tune.

An own copy of the JAX package's data/image_folder.py (numpy and PIL only),
so the port yields the same batches bit for bit. Walks `<root>/<class>/*`
like torchvision.datasets.ImageFolder and emits (images, labels) numpy
batches: images (B, H, W, 3) float32 NHWC, resized to `image_size`, an
optional random horizontal flip, scaled to [0, 1] and ImageNet-normalized;
labels (B,) int32 class indices in sorted directory order. (The VGG16
module normalizes again inside: the reference's double normalization, kept
as the JAX package keeps it.)

The shuffle and the flips of an epoch come from numpy's default_rng seeded
by (seed, epoch), and `epoch` counts the iterations started, so a resumed
run that sets `loader.epoch` replays the uninterrupted run's order.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


class ImageFolder:
    def __init__(self, root: str, image_size: int = 256,
                 normalize: bool = True) -> None:
        self.root = root
        self.image_size = image_size
        self.normalize = normalize
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx: Dict[str, int] = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() in _EXTS:
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, flip: bool) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[index]
        size = self.image_size
        with Image.open(path) as img:
            img = img.convert("RGB")
            if img.size != (size, size):
                img = img.resize((size, size), Image.BILINEAR)
            arr = np.asarray(img, dtype=np.float32) / 255.0
        if flip:
            arr = arr[:, ::-1, :]
        if self.normalize:
            arr = (arr - _IMAGENET_MEAN) / _IMAGENET_STD
        return np.ascontiguousarray(arr), label


class ImageFolderLoader:
    """Threaded, prefetching (images, labels) batch iterator."""

    def __init__(self, dataset: ImageFolder, batch_size: int,
                 shuffle: bool = True, random_flip: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.random_flip = random_flip
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)
        flips = (rng.random(len(order)) < 0.5) if self.random_flip \
            else np.zeros(len(order), bool)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a bounded put that gives up once the consumer has stopped: an
            # abandoned iterator must not leave this thread blocked forever
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
                    samples = list(pool.map(
                        self.dataset.load, [int(i) for i in idx],
                        [bool(flips[i]) for i in idx]))
                    images = np.stack([s[0] for s in samples])
                    labels = np.asarray([s[1] for s in samples], np.int32)
                    if not put_or_stop((images, labels)):
                        return
            put_or_stop(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
