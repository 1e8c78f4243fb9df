"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the reference package, builds nothing, and its entry
points refuse to run on the CPU unless the caller names it."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _module_names():
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def test_importing_every_module_leaves_no_jax_and_no_reference_package():
    mods = _module_names()
    assert len(mods) >= 40 and "repro_torch.launch.serve" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(PKG.parent)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels.build as b\n"
        "assert not b._LIBS, 'a kernel library was loaded at import'\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax_or_the_reference_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro", "triton"} & set(roots), (path, roots)


def test_cuda_sources_call_no_library_kernel():
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert {s.name for s in sources} == {
        "common.cuh", "spmv_csr.cu", "spmv_ell.cu", "spmv_sell.cu", "spmv_bell.cu",
        "spmv_fused.cu", "spmv_bcsr.cu", "spmspv_csc.cu"}
    from repro_torch.kernels.build import KERNEL_SOURCES

    assert {f"{n}.cu" for n in KERNEL_SOURCES} == {s.name for s in sources if s.suffix == ".cu"}
    for s in sources:
        text = s.read_text().lower()
        for banned in ("cusparse", "cublas", "torch/extension", "cutlass", "thrust"):
            assert banned not in text, (s.name, banned)
        if s.suffix == ".cu":
            assert "__global__" in text and 'extern "c"' in text and "cudagetlasterror" in text
            assert "replaces:" in text and "bound on this card" in text


def test_entry_points_without_device_raise_where_cuda_is_absent():
    assert not torch.cuda.is_available()  # these tests run on a CPU-only machine
    from repro_torch.core.session import build_tuner
    from repro_torch.kernels import (
        compile_spmspv,
        compile_spmv,
        kernel_memoized,
        prepare,
        resolve_device,
    )
    from repro_torch.kernels.ref import spmv_dense
    from repro_torch.kernels.spmspv import csc_from_dense
    from repro_torch.sparse import formats

    dense = np.eye(16, dtype=np.float32)
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: prepare(dense, "csr"),
        lambda: compile_spmv(dense, "ell"),
        lambda: kernel_memoized("k", "csr"),
        lambda: formats.from_dense(dense, "sell"),
        lambda: formats.csr_from_dense(dense),
        lambda: formats.container_from_numpy("ell", {"data": dense, "cols": dense}, shape=(16, 16)),
        lambda: spmv_dense(dense, np.ones(16, np.float32)),
        lambda: build_tuner(),
        lambda: compile_spmspv(dense),
        lambda: csc_from_dense(dense),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert prepare(dense, "csr", device="cpu").data.device.type == "cpu"


def test_cuda_timer_and_build_refuse_a_machine_without_the_toolchain(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    from repro_torch.utils.timing import cuda_time_ms

    with pytest.raises(RuntimeError):
        cuda_time_ms(lambda: None)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    assert build.build_dir() == tmp_path / "b"
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_library("spmv_csr")
    # the library name is keyed by the sources: same sources, same name
    assert build.library_path("spmv_csr") == build.library_path("spmv_csr")
    assert build.library_path("spmv_csr").name != build.library_path("spmv_ell").name
    with pytest.raises(ValueError):
        build._start_build("spmv_coo")
    with pytest.raises(RuntimeError, match="cudaError 98"):
        build.check_launch(98, "csr_spmv")
    build.check_launch(0, "csr_spmv")
