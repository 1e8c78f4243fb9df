"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``build/repro_torch/`` at the root of the checkout (override with the
``REPRO_TORCH_BUILD_DIR`` environment variable) under a name keyed by a hash
of the source, the shared header and the compiler flags: editing a source
rebuilds it at next use, and stale libraries are simply never loaded again.
Delete the directory to force a rebuild.

The build happens at first use, never at import; ``build_all`` starts one
``nvcc`` per source in parallel. A failed build raises — nothing here falls
back to a plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = (
    "spmv_csr", "spmv_ell", "spmv_sell", "spmv_bell", "spmv_fused", "spmv_bcsr",
    "spmspv_csc",
)
_SHARED_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, in the build log
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], "ctypes._CFuncPtr"] = {}


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    # src/repro_torch/kernels/build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            candidates.append(str(Path(root) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH, /usr/local/cuda); "
        "the CUDA kernels cannot be built on this machine"
    )


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for fname in (f"{name}.cu",) + _SHARED_HEADERS:
        h.update(fname.encode())
        h.update((CSRC_DIR / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_source_hash(name)}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, temp path, final path)."""
    if name not in KERNEL_SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; have {KERNEL_SOURCES}")
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees a whole file or none
    return log


def ptxas_usage(log: str) -> list[dict]:
    """Per compiled kernel (in build-log order): its mangled name, registers
    per thread and spill bytes, from the ``-Xptxas=-v`` lines of a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = {"function": m.group(1), "registers": None, "spill_bytes": 0}
            out.append(entry)
        elif entry is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def build_all(names: tuple[str, ...] = KERNEL_SOURCES) -> dict:
    """Build every missing library, one ``nvcc`` per source, all in parallel.

    Returns ``{"seconds": wall time, "built": [names], "log": {name: text}}``.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    started = [(n, *_start_build(n)) for n in todo]
    errors, logs = [], {}
    for n, proc, tmp, out in started:  # wait for all, so none is left running
        try:
            logs[n] = _finish_build(n, proc, tmp, out)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "built": todo, "log": logs}


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(name: str, symbol: str, argtypes: list) -> "ctypes._CFuncPtr":
    """``lib.symbol`` with ``argtypes`` set and an ``int`` (cudaError_t) result.

    Pointers and the stream must be declared ``c_void_p``: undeclared, ctypes
    would pass each Python int as a 32-bit C int and cut the pointer."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise if a launch helper returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
