"""What the benchmark may import: nothing of JAX or of the JAX package the
port was made from, compared by whole top-level names (``repro_torch``
begins with ``repro``); nothing under the repository's ``benchmarks/``;
and, in the reference, nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench.harness.catalog import BENCH_DIR, ROOT
from bench.harness.main import FORBIDDEN_MODULES, forbidden_modules

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    found = top_level_imports(path)
    assert not found & set(FORBIDDEN_MODULES), found
    assert "benchmarks" not in found
    if "tests" not in path.relative_to(BENCH_DIR).parts:
        assert "benchmarks/" not in path.read_text()  # reads no file of that folder


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN_MODULES
    planted = ("repro_torch_like", "jax.numpy")
    try:
        for name in planted:
            sys.modules[name] = sys
        assert forbidden_modules() == ["jax"]
    finally:
        for name in planted:
            del sys.modules[name]


def test_a_run_on_the_cpu_holds_no_forbidden_module(tmp_path):
    """A small cell driven end to end in a fresh process, as ``run.py``
    drives it, then the modules it holds."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(Path(__file__).parent)!r}]
import torch
torch.set_num_threads(1)
from pathlib import Path
from conftest import small_catalog
from bench.harness.main import run_cell, forbidden_modules
cat = small_catalog(Path({str(tmp_path)!r}))
res, _, _ = run_cell(cat, "ffn0.decode4", 3, 0.2, False, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"correct": res["correct"], "bad": forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": []}
