"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax",
       "lora_sdr_lightweight_standalone_library_clean_tpu"}
PORT = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"
BENCH = ROOT / "portbench"


def _top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_level_imports(path) & JAX, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        found = _top_level_imports(path)
        assert PORT not in found and not found & JAX, path
        assert found <= {"__future__", "dataclasses", "math", "torch"}, \
            (path, found)


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_the_program_load_no_jax():
    found = _modules_after(
        "import portbench.run, portbench.control\n"
        "from portbench import program\nprogram.load()")
    assert PORT in found
    assert not found & JAX, found & JAX


def test_reference_loads_nothing_of_the_program():
    found = _modules_after("import portbench.reference.rx, "
                           "portbench.reference.phy")
    assert PORT not in found and not found & JAX


def test_bench_py_is_not_read():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert "bench.py" not in path.read_text(), path
