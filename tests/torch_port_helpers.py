"""Helpers shared by the ``test_torch_*`` parity tests: carry the reference
package's containers across as numpy, and the scaled-error rule of
``test_kernels._check``."""

import dataclasses

import numpy as np
import pytest
import torch

# The suite runs in several worker processes on a few cores, and each worker
# collects every test file, so this holds in all of them: one intra-op
# thread per process. At the default (a thread per core in every worker)
# the pools oversubscribe the cores and the port's many small CPU ops wait
# on one another's threads.
torch.set_num_threads(1)

# the six schedules of tests/test_kernels.py, as keyword dicts so each
# package builds its own KernelSchedule from them
SCHEDULE_KW = [
    {},
    dict(rows_per_block=8, nnz_tile=128, unroll=1),
    dict(rows_per_block=32, nnz_tile=256, unroll=2),
    dict(rows_per_block=128, nnz_tile=512, unroll=4),
    dict(rows_per_block=16, nnz_tile=128, unroll=1, accum_dtype="bfloat16"),
    dict(rows_per_block=64, nnz_tile=128, dimension_semantics="parallel"),
]

PATTERNS = ["fem", "powerlaw", "block", "banded", "denserows"]
FORMATS = ["csr", "ell", "bell", "sell"]

ARRAY_FIELDS = {
    "csr": ("data", "indices", "indptr", "row_ids"),
    "ell": ("data", "cols"),
    "bell": ("data", "block_cols"),
    "sell": ("data", "cols", "slice_ptr", "slice_width", "row_ids"),
    "bcsr": ("data", "block_cols", "block_rows", "block_ptr"),
}
STATIC_FIELDS = {
    "csr": ("shape",),
    "ell": ("shape",),
    "bell": ("shape", "br", "bc"),
    "sell": ("shape", "C"),
    "bcsr": ("shape", "br", "bc"),
}


def ref_arrays(fmt, mat):
    """A reference (JAX) container as ``(arrays, static)`` of numpy/python."""
    arrays = {n: np.asarray(getattr(mat, n)) for n in ARRAY_FIELDS[fmt]}
    static = {n: getattr(mat, n) for n in STATIC_FIELDS[fmt]}
    return arrays, static


def to_port(fmt, mat):
    """The port's container over the reference container's storage (CPU)."""
    from repro_torch.sparse.formats import container_from_numpy

    arrays, static = ref_arrays(fmt, mat)
    if fmt not in _PLUGIN_CONTAINERS:
        return container_from_numpy(fmt, arrays, device="cpu", **static)
    import torch

    fields = {n: torch.from_numpy(np.array(a, copy=True)) for n, a in arrays.items()}
    return _PLUGIN_CONTAINERS[fmt]()(**fields, **static)


def _bcsr_container():
    from repro_torch.sparse.bcsr import BCSR

    return BCSR


# plugin formats: containers built field by field (container_from_numpy
# carries the seed formats only)
_PLUGIN_CONTAINERS = {"bcsr": _bcsr_container}


@pytest.fixture
def with_bcsr():
    """BCSR registered in BOTH packages for one test, unregistered in both
    afterwards: the registries are process-global and several test files
    share a worker, so no later test may see a fifth format in one package
    only."""
    from repro.sparse import bcsr as ref_bcsr
    from repro.sparse import registry as ref_reg
    from repro_torch.sparse import bcsr as port_bcsr
    from repro_torch.sparse import registry as port_reg

    ref_bcsr.register()
    port_bcsr.register()
    yield
    for reg in (ref_reg, port_reg):
        if "bcsr" in reg.format_names():
            reg.unregister_format("bcsr")


@pytest.fixture
def traced():
    """The port's process tracer (off by default) switched on and emptied
    for one test, then left as it was."""
    from repro_torch.obs.trace import tracing

    with tracing() as tracer:
        tracer.clear()
        yield tracer


def reference_profile():
    """The reference cost model's constants as a port ``HardwareProfile``,
    handed over from the test so both packages score with the same numbers."""
    from repro.core import objectives as ref_obj
    from repro_torch.core import objectives as obj

    return obj.HardwareProfile(**dataclasses.asdict(ref_obj.TPU_V5E))


class StubPredictor:
    """Deterministic predictor (the reference tests' stub): a fixed format
    and the given package's default schedule, so plan comparisons exercise
    the partition/cost-model logic, not classifier fitting."""

    def __init__(self, default_schedule, fmt: str = "csr"):
        self.fmt, self.schedule = fmt, default_schedule

    def predict_format(self, feats, objective):
        return self.fmt

    def predict_schedule(self, feats, objective):
        return self.schedule


def hetero_matrix(n: int = 512) -> np.ndarray:
    """The reference tests' heterogeneous matrix: a dense band stacked on a
    power-law half (``tests/test_partition.py``)."""
    from repro.sparse.generate import random_matrix

    top = random_matrix(n, n // 4, "denseband", seed=1)[: n // 2]
    bot = random_matrix(n, 3.0, "powerlaw", seed=2)[n // 2 :]
    return np.vstack([top, bot]).astype(np.float32)


def plan_pair(dense, fmts, k, kw=None):
    """The same forced CompositePlan in both packages (formats round-robin
    over ``k`` nnz-balanced blocks), as the reference's fused tests force it."""
    from repro.core.objectives import ObjectiveValues as RefOV
    from repro.kernels.common import KernelSchedule as RefSchedule
    from repro.partition import partition_rows as ref_partition
    from repro.partition.plan import BlockPlan as RefBlockPlan
    from repro.partition.plan import CompositePlan as RefCompositePlan
    from repro_torch.core.objectives import ObjectiveValues
    from repro_torch.kernels.common import KernelSchedule
    from repro_torch.partition import partition_rows
    from repro_torch.partition.plan import BlockPlan, CompositePlan

    out = []
    for part_fn, Sched, OV, BP, CP in (
        (ref_partition, RefSchedule, RefOV, RefBlockPlan, RefCompositePlan),
        (partition_rows, KernelSchedule, ObjectiveValues, BlockPlan, CompositePlan),
    ):
        sched, zero = Sched(**(kw or {})), OV(0.0, 0.0, 0.0, 0.0)
        part = part_fn(dense, k)
        blocks = tuple(
            BP(b, fmts[i % len(fmts)], sched, zero, fmts[i % len(fmts)])
            for i, b in enumerate(part.blocks)
        )
        out.append(CP("latency", part, blocks, zero, zero, fmts[0], sched))
    return tuple(out)


def assert_same_storage(fmt, ref_mat, port_mat):
    """Array by array, dtype and values exact; static fields equal."""
    for n in ARRAY_FIELDS[fmt]:
        a = np.asarray(getattr(ref_mat, n))
        b = getattr(port_mat, n).numpy()
        assert a.dtype == b.dtype, (fmt, n, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{fmt}.{n}")
    for n in STATIC_FIELDS[fmt]:
        assert tuple(np.atleast_1d(getattr(ref_mat, n))) == tuple(
            np.atleast_1d(getattr(port_mat, n))
        ), (fmt, n)


def tol_for(accum_dtype: str) -> float:
    return 3e-2 if accum_dtype == "bfloat16" else 1e-4


def assert_scaled_close(y, ref, tol):
    """The ``_check`` rule of tests/test_kernels.py: compare after scaling by
    max |ref| (summation order differs between the implementations)."""
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(y / scale, ref / scale, atol=tol, rtol=tol)


def schedule_dict(s) -> dict:
    return dataclasses.asdict(s)


def same_clocks(monkeypatch, *modules):
    """Give each module its own host clock with one shared script: the k-th
    ``time.perf_counter()`` read in any of them returns the same value. The
    bandit, drift, the watchdog and SLO burn learn from wall time, which
    differs between the packages; with the same clock their decisions must
    agree exactly. A module keeps the rest of ``time``."""
    import time
    import types

    for mod in modules:
        ticks = iter(range(10**9))
        # steps of 1..5 units: measured times vary from call to call
        clock = types.SimpleNamespace(
            **{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
        state = {"t": 0.0}

        def perf_counter(ticks=ticks, state=state):
            k = next(ticks)
            state["t"] += (1 + (k * 7) % 5) * 1e-4
            return state["t"]

        clock.perf_counter = perf_counter
        monkeypatch.setattr(mod, "time", clock)
