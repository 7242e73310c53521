"""Nothing of JAX or the JAX package in the benchmark or in what a run
loads, top-level names compared whole; the reference imports nothing of
the program."""

import ast
import subprocess
import sys

from conftest import ROOT
from portbench.core import imports, manifest

FILES = sorted(p for p in manifest.BENCH.rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_in_the_sources():
    for path in FILES:
        assert not set(imported(path)) & imports.FORBIDDEN, path


def test_reference_is_plain():
    for path in (manifest.BENCH / "reference").glob("*.py"):
        assert "articulatory_tpu_torch" not in set(imported(path)), path


def test_names_compared_whole():
    sys.modules.setdefault("articulatory_tpu_torch", sys.modules[__name__])
    assert "articulatory_tpu_torch" not in imports.forbidden_loaded()


def test_a_run_loads_no_jax():
    """A tiny run's process, after its window: no JAX, no JAX package."""
    code = (
        "import sys, time; sys.path.insert(0, 'portbench/tests');"
        "from conftest import tiny, CPU;"
        "from portbench.core import manifest, runner, imports;"
        "r = runner.run_cell(tiny('ema-decode-b64'), manifest.benchmark(),"
        " 1, 0.2, False, CPU, time.perf_counter());"
        "print(r is not None, imports.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split("\n")[-2] == "True []", out.stderr[-2000:]
