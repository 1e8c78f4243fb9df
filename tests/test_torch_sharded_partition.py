"""The multi-device partitioned executor (``ShardedPartitionedSpmv``,
``shard_partitioned``) on a 4-entry CPU mesh, against the reference's on
four forced host devices.

The reference's cases (``tests/test_partition_multidevice.py``) run on the
port's ``spmv_mesh(4, device="cpu")``, where each block's ELL kernel takes
its plain version; the reference runs as its own CI job runs it, in a
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
with interpret-mode kernels, and its stacked carrier planes, padded rows,
re-cut partitions and ``y`` come back through an ``.npz``."""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.dist.sharding import SPMV_RULES, spec_for, spmv_mesh
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.kernels.ell import ell_spmv
from repro_torch.partition import (
    ShardedPartitionedSpmv,
    partition_rows,
    plan_partitioned,
    shard_partitioned,
)
from repro_torch.sparse.generate import random_matrix
from torch_port_helpers import assert_scaled_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DEV = 4

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.kernels.common import DEFAULT_SCHEDULE
    from repro.partition import partition_rows, plan_partitioned, shard_partitioned
    from repro.sparse.generate import random_matrix
    assert len(jax.devices()) == 4

    def hetero(n):
        top = random_matrix(n, n // 4, "denseband", seed=1)[: n // 2]
        bot = random_matrix(n, 3.0, "powerlaw", seed=2)[n // 2 :]
        return np.vstack([top, bot]).astype(np.float32)

    class Stub:
        def predict_format(self, feats, objective):
            return "csr"

        def predict_schedule(self, feats, objective):
            return DEFAULT_SCHEDULE

    out = {}
    for case, n, cut in (("four", 256, 4), ("recut", 256, 8), ("plan", 512, None)):
        dense = hetero(n)
        x = np.random.default_rng(n + (cut or 0)).normal(size=n).astype(np.float32)
        part = plan_partitioned(Stub(), dense, "latency") if cut is None else partition_rows(dense, cut)
        s = shard_partitioned(dense, part)
        out[case + "_data"] = np.asarray(s.data)
        out[case + "_cols"] = np.asarray(s.cols)
        out[case + "_R"] = np.asarray(s.padded_rows)
        out[case + "_bounds"] = np.asarray([(b.row_start, b.row_end) for b in s.partition.blocks])
        out[case + "_y"] = np.asarray(s(x))
    np.savez(sys.argv[1], **out)
""")
CASES = {"four": (256, 4), "recut": (256, 8), "plan": (512, None)}


def _hetero(n: int = 256) -> np.ndarray:
    top = random_matrix(n, n // 4, "denseband", seed=1)[: n // 2]
    bot = random_matrix(n, 3.0, "powerlaw", seed=2)[n // 2 :]
    return np.vstack([top, bot]).astype(np.float32)


class _Stub:
    def predict_format(self, feats, objective):
        return "csr"

    def predict_schedule(self, feats, objective):
        return DEFAULT_SCHEDULE


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "ref.npz"
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src"), "HOME": str(path.parent)}
    r = subprocess.run([sys.executable, "-c", _REF, str(path)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as blob:
        return dict(blob)


@pytest.fixture
def mesh():
    return spmv_mesh(N_DEV, device="cpu")


def _port(case: str, mesh):
    n, cut = CASES[case]
    dense = _hetero(n)
    x = np.random.default_rng(n + (cut or 0)).normal(size=n).astype(np.float32)
    part = plan_partitioned(_Stub(), dense, "latency") if cut is None else partition_rows(dense, cut)
    return dense, x, shard_partitioned(dense, part, mesh=mesh)


def test_spmv_rules_map_blocks_to_data_axis(mesh):
    assert spec_for(mesh, (4, 8, 16), ("blocks", None, None), SPMV_RULES) == ("data",)
    assert spec_for(mesh, (64,), (None,), SPMV_RULES) == ()  # X replicated


def test_sharded_executor_matches_dense_reference(mesh):
    dense = _hetero(256)
    x = np.random.default_rng(0).normal(size=dense.shape[1]).astype(np.float32)
    sharded = shard_partitioned(dense, partition_rows(dense, N_DEV), mesh=mesh)
    assert isinstance(sharded, ShardedPartitionedSpmv) and sharded.n_blocks == N_DEV
    y = sharded(x)
    assert isinstance(y, np.ndarray) and y.shape == (dense.shape[0],)
    assert_scaled_close(y, dense.astype(np.float64) @ x, 1e-4)


def test_sharded_y_shards_stay_local(mesh):
    dense = _hetero(256)
    x = np.random.default_rng(1).normal(size=dense.shape[1]).astype(np.float32)
    sharded = shard_partitioned(dense, partition_rows(dense, N_DEV), mesh=mesh)
    y = sharded.sharded_call(x)
    # one (1, R) row-block output per mesh entry, each on its own device
    assert len(y) == N_DEV
    assert [t.device for t in y] == mesh.devices
    assert {tuple(t.shape) for t in y} == {(1, sharded.padded_rows)}
    assert [d.device for d in sharded.data] == mesh.devices


def test_sharded_repartitions_to_mesh_extent(mesh):
    import logging

    from repro_torch.partition.executor import log

    dense = _hetero(256)
    x = np.random.default_rng(2).normal(size=dense.shape[1]).astype(np.float32)
    seen: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log.addHandler(handler)
    try:
        sharded = shard_partitioned(dense, partition_rows(dense, 2 * N_DEV), mesh=mesh)
    finally:
        log.removeHandler(handler)
    assert sharded.n_blocks == N_DEV
    assert any("re-partitioning 8 block(s) -> 4 device(s)" in m for m in seen)
    assert_scaled_close(sharded(x), dense.astype(np.float64) @ x, 1e-4)
    with pytest.raises(ValueError, match="mesh extent"):
        ShardedPartitionedSpmv(dense, partition_rows(dense, 2), mesh=mesh)


def test_sharded_from_composite_plan(mesh):
    """The CompositePlan input path: carrier schedule from block 0."""
    dense = _hetero(512)
    plan = plan_partitioned(_Stub(), dense, "latency")
    x = np.random.default_rng(3).normal(size=dense.shape[1]).astype(np.float32)
    sharded = shard_partitioned(dense, plan, mesh=mesh)
    assert sharded.schedule == plan.blocks[0].schedule
    assert_scaled_close(sharded(x), dense.astype(np.float64) @ x, 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_carrier_partition_and_y_equal_the_references(reference, mesh, case):
    dense, x, sharded = _port(case, mesh)
    data = np.stack([d.numpy() for d in sharded.data])
    cols = np.stack([c.numpy() for c in sharded.cols])
    np.testing.assert_array_equal(data, reference[f"{case}_data"])
    np.testing.assert_array_equal(cols, reference[f"{case}_cols"])
    assert sharded.padded_rows == int(reference[f"{case}_R"])
    bounds = [(b.row_start, b.row_end) for b in sharded.partition.blocks]
    assert bounds == [tuple(map(int, b)) for b in reference[f"{case}_bounds"]]
    y = sharded(x)
    assert_scaled_close(y, reference[f"{case}_y"], 1e-4)
    assert_scaled_close(y, dense.astype(np.float64) @ x, 1e-4)


def test_every_block_runs_the_ell_wrapper_on_its_device(mesh, monkeypatch):
    """Each call goes through ``kernels.ell.ell_spmv`` once per block (the
    CPU tensors take its plain version; on a card it launches B2)."""
    import repro_torch.partition.executor as ex

    seen = []

    def spy(data, cols, x, schedule):
        seen.append((data.device, x.device, tuple(data.shape)))
        return ell_spmv(data, cols, x, schedule)

    monkeypatch.setattr(ex, "ell_spmv", spy)
    dense, x, sharded = _port("four", mesh)
    sharded(x)
    assert len(seen) == N_DEV and all(d == xd == torch.device("cpu") for d, xd, _ in seen)
    assert {s for _, _, s in seen} == {tuple(sharded.data[0].shape)}
