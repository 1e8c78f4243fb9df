"""Fixtures of the benchmark's own tests (``pytest bench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is none; the decision is made when a
test runs, never while a module is imported. On the card:
``python3 -m pytest bench/tests -m card``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench.harness.catalog import BENCH_DIR, Catalog  # noqa: E402

# a tuner small enough for a test: two presets at a tiny scale
SMALL_TUNER = {"scale": 0.0008, "names": ["shar_te2-b3", "rim"], "n_extra": 0,
               "fit_overhead": False}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small_catalog(tmp_path: Path, n: int = 384, nnz_per_row: int = 40, d: int = 64,
                  f: int = 96) -> Catalog:
    """A copy of the benchmark under ``tmp_path`` with its configurations and
    traced stretches cut to a size a CPU test holds: the same files, smaller
    numbers."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())

    def edit(name, fn):
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        fn(cfg)
        cfg["tuner"] = SMALL_TUNER
        path.write_text(json.dumps(cfg))

    for mix in (bench / "traffic").glob("*.json"):  # a short traced stretch
        m = json.loads(mix.read_text())
        m.update(profile_steps=min(m["profile_steps"], 64), label_steps=min(m["label_steps"], 32))
        mix.write_text(json.dumps(m))
    edit("human_gene2", lambda c: c["matrix"].update(n_rows=n, n_cols=n, nnz=n * nnz_per_row))
    edit("deepseek-moe-16b.ffn0.s50", lambda c: c.update(hidden_size=d, intermediate_size=f))
    return Catalog(spec, bench)


@pytest.fixture
def make_catalog(tmp_path):
    """``small_catalog`` under this test's ``tmp_path``."""
    return lambda **sizes: small_catalog(tmp_path, **sizes)


@pytest.fixture
def catalog(make_catalog):
    return make_catalog()
