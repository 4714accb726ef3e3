"""ctypes bindings for the native host-pipeline kernels
(native/mask_pipeline.cc), a copy of the JAX package's data/native.py.

The port compiles its own copy of the library on first use, with the flags
of native/Makefile, into `_build/native-<hash>/` inside the package (listed
in `.gitignore`), keyed by a hash of the source and the flags. The build
holds an exclusive `fcntl.flock` on a lock file there and compiles to a
temporary name that `os.replace` moves onto the target, so a process never
opens a half-written library and concurrent processes build it once. The
library the JAX package builds in place under native/ is never opened.
Every entry point returns None when the library cannot be built (no
compiler), and the callers fall back to the numpy versions (data/masks.py),
so the port runs with or without it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE), "native", "mask_pipeline.cc")
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
LIBRARY = "libmask_pipeline.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> str:
    """Where the port's build of SOURCE lives (it may not exist yet)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + f.read())
    return os.path.join(_PACKAGE, "_build",
                        f"native-{digest.hexdigest()[:16]}", LIBRARY)


def _build(path: str) -> bool:
    """Compile SOURCE to `path` under an exclusive lock, atomically; True
    when the library is there afterwards (built here or by another
    process)."""
    compiler = shutil.which(os.environ.get("CXX", "g++"))
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):
            return True
        if compiler is None:
            return False
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            done = subprocess.run([compiler, *FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True)
            if done.returncode != 0:
                return False
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _load_failed = True
        return None
    lib.generate_masks.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
    ]
    lib.generate_masks.restype = ctypes.c_int
    lib.normalize_minmax_m11.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_library() is not None


def generate_masks_batch(
    config: PyramidGANConfig, batch: int, seed: int, epoch: int = 0,
    p_random: Optional[float] = None, validation: bool = False,
) -> Optional[List[np.ndarray]]:
    """Batched mask schedule via the native kernel; shallow->deep 7-list with
    the same layout as MaskSchedule.batch. None if the library is missing."""
    lib = load_library()
    if lib is None:
        return None
    p_random = config.p_random_mask if p_random is None else p_random
    dims = list(config.pyramid_spatial)  # shallow->deep
    if len(dims) != 5 or max(dims) > 128:
        return None  # the kernel rasterizes into fixed 128x128 buffers
    conv = [np.empty((batch, d, d, 1), np.float32) for d in dims]
    fc7 = np.empty((batch, config.vgg_fc7_dim), np.float32)
    fc8 = np.empty((batch, config.num_classes), np.float32)
    ptrs = (ctypes.c_void_p * 5)(*[c.ctypes.data for c in conv])
    cdims = (ctypes.c_int * 5)(*dims)
    rc = lib.generate_masks(
        ctypes.c_uint64(seed), ctypes.c_uint64(epoch), ctypes.c_int(batch),
        ptrs, cdims,
        fc7.ctypes.data, ctypes.c_int(fc7.shape[1]),
        fc8.ctypes.data, ctypes.c_int(fc8.shape[1]),
        ctypes.c_float(p_random), ctypes.c_int(1 if validation else 0))
    if rc != 0:
        return None
    return conv + [fc7, fc8]


def normalize_image_m11(image_u8: np.ndarray) -> Optional[np.ndarray]:
    """uint8 HWC -> float32 HW3 in [-1, 1] via the native kernel."""
    lib = load_library()
    if lib is None:
        return None
    image_u8 = np.ascontiguousarray(image_u8)
    h, w = image_u8.shape[:2]
    c = 1 if image_u8.ndim == 2 else image_u8.shape[2]
    out = np.empty((h, w, 3), np.float32)
    lib.normalize_minmax_m11(image_u8.ctypes.data, h, w, c, out.ctypes.data)
    return out
