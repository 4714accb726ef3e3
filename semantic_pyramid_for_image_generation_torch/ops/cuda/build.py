"""Build the port's CUDA kernels from `csrc/` and load them through ctypes.

Every source under `csrc/` is compiled by its own `nvcc` process, all started
together, for `sm_90a`; the objects are linked into one shared library with
a plain C interface. The library lands in `_build/<hash>/` inside the
package (listed in `.gitignore`), keyed by a hash of the sources and flags,
so a changed source rebuilds and an unchanged one loads at once. Nothing is
built at import: the first kernel launch (or `build()`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE / "_build"
SOURCES = ("attention.cu", "max_pool.cu", "upsample.cu", "runtime.cu")
HEADERS = ("common.cuh",)
LIBRARY = "libspig_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spig_attention_forward": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "spig_max_pool_2x2": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
    "spig_upsample_2x": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
    "spig_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """Compile every source in parallel, link the library; returns the log."""
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, proc in procs:
        output, _ = proc.communicate()
        log.append(f"== nvcc {name} (exit {proc.returncode})\n{output}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    cmd = [nvcc, *ARCH, "-shared", "-o", str(out_dir / LIBRARY),
           *[str(out_dir / (name + ".o")) for name in SOURCES]]
    link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log.append(f"== link (exit {link.returncode})\n{link.stdout}")
    if link.returncode:
        raise RuntimeError("linking the kernel library failed\n" + "\n".join(log))
    return "\n".join(log)


def build() -> Path:
    """Build the library unless this exact build exists; returns its path."""
    target = BUILD_ROOT / _digest()
    if (target / LIBRARY).exists():
        return target / LIBRARY
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    start = time.perf_counter()
    log = _compile(nvcc, work)
    (work / "build.log").write_text(
        log + f"\nbuild seconds: {time.perf_counter() - start:.1f}\n")
    try:
        os.replace(work, target)
    except OSError:  # another process finished the same build first
        shutil.rmtree(work, ignore_errors=True)
    return target / LIBRARY


def build_log() -> str:
    """nvcc's output of the current build, ptxas register and spill lines
    included (empty before the first build)."""
    path = BUILD_ROOT / _digest() / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _library = lib
        return _library


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status:
        text = library().spig_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
