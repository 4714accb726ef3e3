"""The port's build of the native host library (semantic_pyramid_for_image_
generation_torch/data/native.py): locked and atomic.

Held, on the CPU (g++ is on this host; the native cases skip without it):
  * 12 processes (more than this host's cores) start `_build` on one empty
    directory at once: the compiler runs once, every process finds the
    library afterwards and loads it with both entry points, and no
    temporary file is left behind;
  * a target that exists is not rebuilt, and a failed compile leaves no
    target (the caller then takes the numpy route);
  * the library path is keyed on the source and the flags, inside the
    package's `_build/`, never the JAX package's in-place
    native/libmask_pipeline.so.
Every process is joined within a limit.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from semantic_pyramid_for_image_generation_torch.data import native

REPO = Path(__file__).resolve().parents[1]
WORKERS = 12
LIMIT_S = 240

# one process: wait for the start file, build `path`, count compiler runs,
# load the library
WORKER = """
import ctypes, json, os, sys, time
from semantic_pyramid_for_image_generation_torch.data import native
path, start = sys.argv[1], sys.argv[2]
runs = []
real = native.subprocess.run
native.subprocess.run = lambda *a, **k: runs.append(1) or real(*a, **k)
while not os.path.exists(start):
    time.sleep(0.005)
built = native._build(path)
lib = ctypes.CDLL(path)
print(json.dumps({"built": built, "compiles": len(runs),
                  "symbols": all(hasattr(lib, s) for s in
                                 ("generate_masks", "normalize_minmax_m11"))}))
"""


def _compiler() -> bool:
    return shutil.which(os.environ.get("CXX", "g++")) is not None


@pytest.mark.skipif(not os.path.exists(native.SOURCE),
                    reason="no native source")
def test_concurrent_builds_compile_once_and_all_load(tmp_path):
    if not _compiler():
        pytest.skip("no C++ compiler: the port takes the numpy route")
    path = tmp_path / "out" / native.LIBRARY
    start = tmp_path / "start"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(path),
                               str(start)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(WORKERS)]
    start.touch()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    results = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    assert all(r["built"] and r["symbols"] for r in results)
    assert sum(r["compiles"] for r in results) == 1
    assert sorted(os.listdir(path.parent)) == [native.LIBRARY, "lock"]


def test_an_existing_target_is_not_rebuilt(tmp_path, monkeypatch):
    path = tmp_path / native.LIBRARY
    path.write_bytes(b"")
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: (
        pytest.fail("compiled over an existing target")))
    assert native._build(str(path))


def test_a_failed_compile_leaves_no_target(tmp_path, monkeypatch):
    if not _compiler():
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cc"))
    path = tmp_path / "out" / native.LIBRARY
    assert not native._build(str(path))
    assert sorted(os.listdir(path.parent)) == ["lock"]


def test_the_library_lives_in_the_ports_build_dir():
    path = Path(native.library_path())
    package = REPO / "semantic_pyramid_for_image_generation_torch"
    assert path.parent.parent == package / "_build"
    assert path.parent.name.startswith("native-") and path.name == \
        native.LIBRARY
    assert path != REPO / "native" / "libmask_pipeline.so"
    assert native.FLAGS == ("-O3", "-march=native", "-fPIC", "-shared",
                            "-std=c++17")
    assert "-O3 -march=native -fPIC -shared -std=c++17" in (
        REPO / "native" / "Makefile").read_text()
