"""What the benchmark may load: no JAX, no JAX package anywhere in a run,
and nothing of the program in the plain reference. Module names are
compared by their top-level name, whole (the port's name begins with the
JAX package's)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN
from benchmark.tests.conftest import ROOT

PROGRAM = "semantic_pyramid_for_image_generation_torch"
BENCH_DIR = ROOT / "benchmark"


def loaded_after(code: str) -> set:
    """Top-level names of the modules loaded by `code` in a fresh process."""
    probe = (f"{code}\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "PYTHONPATH": str(ROOT)}).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_nothing_forbidden():
    """A whole small run of every cell of BENCHMARK.json, in a fresh
    process."""
    code = ("from benchmark.tests.conftest import cells, run_small\n"
            "for cell in cells():\n"
            "    run_small(cell, trace=True)")
    loaded = loaded_after(code)
    assert PROGRAM in loaded  # the program under test did run
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


@pytest.mark.parametrize("module", ["benchmark.reference.gan",
                                    "benchmark.reference.finetune",
                                    "benchmark.reference.common"])
def test_reference_loads_nothing_of_the_program(module):
    loaded = loaded_after(f"import {module}")
    assert PROGRAM not in loaded
    assert not loaded & set(FORBIDDEN)


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_names_a_forbidden_module(path):
    names = _imports(path)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    if "reference" in path.parts:
        assert PROGRAM not in names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "semantic_pyramid_for_image_generation"
                        "_tpu_lookalike", sys)
    assert "semantic_pyramid_for_image_generation_tpu" not in (
        run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in run.forbidden_modules()
