"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the reference package, builds nothing, and its entry
points refuse to run on the CPU unless the caller names it."""

import ast
import pathlib
import re
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


# modules of the LM slice; the import checks below cover them with the rest
LM_MODULES = (
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.qwen3_0_6b",
    "repro_torch.optim", "repro_torch.optim.compress", "repro_torch.models",
    "repro_torch.models.param", "repro_torch.models.layers", "repro_torch.models.model",
    "repro_torch.models.sparse_linear", "repro_torch.models.moe",
    "repro_torch.models.recurrent", "repro_torch.configs.shapes",
)
# modules of the training slice
TRAIN_MODULES = (
    "repro_torch.optim.adamw", "repro_torch.optim.schedule", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
    "repro_torch.train.trainer", "repro_torch.launch.train",
)
# modules of the multi-device slice
DIST_MODULES = (
    "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.dist.partition",
    "repro_torch.launch.mesh", "repro_torch.launch.specs", "repro_torch.launch.hlo_analysis",
    "repro_torch.launch.dryrun",
)
# modules of the predictor zoo
ZOO_MODULES = (
    "repro_torch.ml.centroid", "repro_torch.ml.svm", "repro_torch.ml.boosting",
    "repro_torch.ml.forest", "repro_torch.ml.mlp", "repro_torch.ml.model_zoo",
)


# the port's examples: scripts beside the reference's, importable for main(argv)
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_importing_the_examples_leaves_no_jax_and_no_reference_package():
    assert [p.stem for p in EXAMPLES] == [
        "torch_autotune_formats", "torch_quickstart", "torch_serve_lm", "torch_train_lm"]
    code = (
        "import importlib.util, sys\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location(p.rsplit('/', 1)[-1][:-3], p)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main), p\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_importing_every_module_leaves_no_jax_and_no_reference_package():
    mods = _module_names()
    assert len(mods) >= 40 and "repro_torch.launch.serve" in mods
    assert set(LM_MODULES) <= set(mods) and set(ZOO_MODULES) <= set(mods)
    assert set(TRAIN_MODULES) <= set(mods) and set(DIST_MODULES) <= set(mods)
    assert len([m for m in mods if m.startswith("repro_torch.configs.")]) == 12
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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES,
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


# package -> (reference package, its names the port does not export yet,
# names only the port exports)
EXPORTS = {
    "configs": (set(), set()),
    "models": (set(), {"init_cache", "params_from_numpy"}),
    "optim": (set(), {"magnitude_prune"}),
    "train": (set(), {"SpmvRequest", "SpmvServer"}),
    "data": (set(), set()),
    "checkpoint": (set(), set()),
    "sparse": (set(), set()),
    "telemetry": (set(), set()),
    "obs": (set(), set()),
    "ml": (set(), set()),
    "dist": (set(), set()),
    "partition": (set(), set()),
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_package_exports_follow_the_reference(pkg):
    import importlib

    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    later, own = EXPORTS[pkg]
    assert set(port.__all__) == (set(ref.__all__) - later) | own
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for name in later:
        assert not hasattr(port, name), name  # no silent stand-ins


def test_kernels_export_spmm_beside_spmv():
    import repro.kernels as ref
    import repro_torch.kernels as port

    assert {"spmm", "spmv", "spmspv"} <= set(port.__all__)
    assert {"spmm_pallas", "spmv_pallas"} <= set(ref.__all__)
    assert port.spmm.__module__ == "repro_torch.kernels.ops"


def test_cuda_sources_call_no_library_kernel():
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert {s.name for s in sources} == {
        "common.cuh", "block_spmv.cuh", "spmv_csr.cu", "spmv_ell.cu", "spmv_sell.cu",
        "spmv_bell.cu", "spmv_fused.cu", "spmv_bcsr.cu", "spmspv_csc.cu", "spmm_ell.cu"}
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
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import spmm_dense, spmv_dense
    from repro_torch.kernels.spmspv import csc_from_dense
    from repro_torch.models import init_cache, init_params, model_specs, params_from_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.sparse import formats
    from repro_torch.train.trainer import init_train_state

    cfg = get_config("qwen3-0.6b", reduced_config=True)

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
        lambda: spmm_dense(dense, np.ones((16, 2), np.float32)),
        lambda: init_params(model_specs(cfg), None, "float32"),
        lambda: params_from_numpy({"w": dense}),
        lambda: init_cache(cfg, 1, 8),
        lambda: init_train_state(cfg, AdamWConfig()),
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


# the host-side launch rules of B8 (ELL SpMM) and B3 (SELL)
LAUNCH_RULES = {
    "repro_torch.kernels.ell": ("spmm_launch_plan", "spmm_plan_choices", "_spmm_launch",
                                "ell_live_width", "spmm_slots_read", "SPMM_CHUNK",
                                "SPMM_WARPS_PER_CTA", "SPMM_SPLIT_CHOICES"),
    "repro_torch.kernels.sell": ("sell_launch_plan", "sell_grid", "sell_plan_choices",
                                 "_sell_launch", "sell_live_width", "sell_slots_read",
                                 "SELL_ROW_THREADS"),
}


@pytest.mark.parametrize("module", sorted(LAUNCH_RULES))
def test_launch_rules_exist_and_import_nothing_of_the_reference(module):
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(PKG.parent)!r})\n"
        f"m = importlib.import_module({module!r})\n"
        f"missing = [n for n in {LAUNCH_RULES[module]!r} if not hasattr(m, n)]\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def _constexprs(*names: str) -> dict:
    """``constexpr int`` values of csrc sources, a ``spmv::`` name resolved
    from common.cuh."""
    vals = {}
    for name in ("common.cuh",) + names:
        for m in re.finditer(r"constexpr int (\w+) = ([\w:]+);", (PKG / "csrc" / name).read_text()):
            v = m.group(2).removeprefix("spmv::")
            vals[m.group(1)] = int(v) if v.isdigit() else vals[v]
    return vals


# the constants each host plan shares with its kernel: {python name: C name}
PLAN_CONSTANTS = {
    "spmm_ell.cu": ("repro_torch.kernels.ell", {"SPMM_CHUNK": "kChunk",
                                                "SPMM_WARPS_PER_CTA": "kWarpsPerCta"}),
    "spmv_sell.cu": ("repro_torch.kernels.sell", {"SELL_MAX_THREADS": "kMaxThreads"}),
}


@pytest.mark.parametrize("name", ["spmm_ell.cu", "spmv_sell.cu", "block_spmv.cuh"])
def test_redesigned_kernels_add_without_atomics_and_plan_per_device(name):
    text = (PKG / "csrc" / name).read_text()
    assert not re.search(r"\batomic\w*\s*\(", text)  # no atomicAdd, atomicCAS, ...
    if name == "block_spmv.cuh":  # the launch plan is kept per device and S
        assert "cudaGetDevice(&dev)" in text and "planned[dev][S]" in text
        return
    # the host plan's constants are the kernel's (on the card the built
    # library's <source>_constants is checked against them too)
    import importlib

    module, names = PLAN_CONSTANTS[name]
    m = importlib.import_module(module)
    c = _constexprs(name)
    assert {py: getattr(m, py) for py in names} == {py: c[cn] for py, cn in names.items()}
