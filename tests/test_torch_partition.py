"""Partitioned SpMV, port vs reference: the partitioner (identical
boundaries, nnz and features), composite planning on an injected cost
model, the sequential executor, the session (``partitioned_optimize``,
cache JSON replay, mode keyed by budget, ``serve_partitioned``), the server
and the CLI. Both packages plan with the reference tests' stub predictor
and score with the reference's constants (``CostModel(reference_profile())``
against ``TpuCostModel()``), so every decision must agree exactly and every
modeled value to rtol 1e-9."""

import json
import math

import numpy as np
import pytest
import torch

from repro.core.autotuner import AutoSpMV as RefAutoSpMV
from repro.core.session import AutoSpmvSession as RefSession
from repro.kernels import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.partition import compile_partitioned as ref_compile_partitioned
from repro.partition import partition_rows as ref_partition
from repro.partition import plan_partitioned as ref_plan_partitioned
from repro.partition.plan import combine as ref_combine
from repro.sparse.generate import random_matrix
from repro.train.serve import SpmvRequest as RefRequest
from repro.train.serve import SpmvServer as RefServer
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.cache import TuningCache
from repro_torch.core.objectives import OBJECTIVES, CostModel, ObjectiveValues
from repro_torch.core.session import AutoSpmvSession, PartitionedResult
from repro_torch.kernels import DEFAULT_SCHEDULE
from repro_torch.kernels.ops import clear_kernel_memo
from repro_torch.partition import (
    PartitionedSpmv,
    compile_partitioned,
    partition_rows,
    plan_partitioned,
)
from repro_torch.partition.plan import combine
from repro_torch.train.serve import SpmvRequest, SpmvServer

from torch_port_helpers import (
    FORMATS,
    StubPredictor,
    assert_scaled_close,
    hetero_matrix,
    plan_pair,
    reference_profile,
    tol_for,
    with_bcsr,  # noqa: F401  (fixture)
)


def _cost_model():
    return CostModel(reference_profile())


def _tuners(fmt="csr"):
    """(port, reference) tuners around the stub predictor."""
    return (AutoSpMV(predictor=StubPredictor(DEFAULT_SCHEDULE, fmt), device="cpu"),
            RefAutoSpMV(predictor=StubPredictor(REF_DEFAULT, fmt)))


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _assert_same_partition(ours, ref):
    assert (ours.n_rows, ours.n_cols, ours.n_blocks) == (ref.n_rows, ref.n_cols, ref.n_blocks)
    assert ours.boundaries() == ref.boundaries()
    for a, b in zip(ours.blocks, ref.blocks):
        assert (a.index, a.row_start, a.row_end, a.nnz) == (b.index, b.row_start, b.row_end, b.nnz)
        assert a.features.dict() == b.features.dict()
    assert ours.imbalance() == pytest.approx(ref.imbalance(), rel=1e-12)


def _assert_same_values(a, b):
    assert a.feasible == b.feasible
    for name in OBJECTIVES:
        va, vb = a.get(name), b.get(name)
        if math.isinf(vb):
            assert va == vb
        else:
            assert va == pytest.approx(vb, rel=1e-9, abs=1e-30)


def _assert_same_plan(ours, ref):
    _assert_same_partition(ours.partition, ref.partition)
    assert (ours.n_blocks, ours.formats, ours.monolithic_fmt, ours.objective) == (
        ref.n_blocks, ref.formats, ref.monolithic_fmt, ref.objective)
    assert [b.predicted_fmt for b in ours.blocks] == [b.predicted_fmt for b in ref.blocks]
    assert [b.schedule.as_dict() for b in ours.blocks] == [b.schedule.as_dict() for b in ref.blocks]
    for a, b in zip(ours.blocks, ref.blocks):
        _assert_same_values(a.modeled, b.modeled)
    _assert_same_values(ours.modeled, ref.modeled)
    _assert_same_values(ours.monolithic, ref.monolithic)
    assert ours.gain() == pytest.approx(ref.gain(), rel=1e-9, abs=1e-12)
    assert ours.searched == ref.searched


# ---------------------------------------------------------------- partitioner


@pytest.mark.parametrize("pattern", ["banded", "powerlaw", "denseband", "fem", "block"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_partition_rows_identical(pattern, k):
    dense = random_matrix(160, 6.0, pattern, seed=7).astype(np.float32)
    _assert_same_partition(partition_rows(dense, k), ref_partition(dense, k))
    raw, ref_raw = partition_rows(dense, k, refine=False), ref_partition(dense, k, refine=False)
    _assert_same_partition(raw, ref_raw)


def _edge_case(name):
    if name == "empty":
        return np.zeros((0, 8), np.float32), 4
    if name == "all_empty_rows":
        return np.zeros((40, 40), np.float32), 4
    if name == "one_hub_row":
        dense = np.zeros((32, 32), np.float32)
        dense[11, :] = 1.0
        return dense, 4
    if name == "more_blocks_than_rows":
        return np.eye(3, dtype=np.float32), 8
    raise ValueError(name)


@pytest.mark.parametrize("case", ["empty", "all_empty_rows", "one_hub_row", "more_blocks_than_rows"])
def test_partition_edge_cases_identical(case):
    dense, k = _edge_case(case)
    ours, ref = partition_rows(dense, k), ref_partition(dense, k)
    _assert_same_partition(ours, ref)
    if case == "one_hub_row":
        assert sorted(b.nnz for b in ours.blocks) == [0, 0, 0, 32]
    if case == "more_blocks_than_rows":
        assert ours.n_blocks == 3


def test_partition_rejects_what_the_reference_rejects():
    for bad in (lambda f: f(np.eye(3, dtype=np.float32), 0),
                lambda f: f(np.ones(5, np.float32), 2),
                lambda f: f(np.eye(4, dtype=np.float32), 2, row_counts=np.ones(3))):
        with pytest.raises(ValueError):
            bad(ref_partition)
        with pytest.raises(ValueError):
            bad(partition_rows)


@pytest.mark.parametrize("seed", range(4))
def test_partition_random_shapes_identical(seed):
    rng = np.random.default_rng(seed)
    n_rows = int(rng.integers(1, 90))
    dense = (rng.random((n_rows, 12)) < 0.2).astype(np.float32)
    for k in (1, 3, 9):
        _assert_same_partition(partition_rows(dense, k), ref_partition(dense, k))


# ----------------------------------------------------------------------- plan


def _plan_matrix(name):
    if name == "hetero":
        return hetero_matrix(512)
    if name == "homogeneous":
        return random_matrix(256, 8.0, "powerlaw", seed=5).astype(np.float32)
    return random_matrix(300, 7.0, name, seed=3).astype(np.float32)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("matrix", ["hetero", "homogeneous", "banded", "block"])
def test_plan_partitioned_identical(matrix, objective):
    dense = _plan_matrix(matrix)
    ours = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), dense, objective,
                            cost_model=_cost_model())
    ref = ref_plan_partitioned(StubPredictor(REF_DEFAULT), dense, objective)
    _assert_same_plan(ours, ref)
    assert [bp.as_dict()["fmt"] for bp in ours.blocks] == list(ours.formats)


def test_plan_hetero_partitions_and_homogeneous_falls_back():
    hetero = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), hetero_matrix(512), "latency",
                              cost_model=_cost_model())
    assert hetero.partitioned and hetero.gain() > 0
    homo = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), _plan_matrix("homogeneous"),
                            "latency", cost_model=_cost_model())
    assert not homo.partitioned and homo.formats == (homo.monolithic_fmt,)


@pytest.mark.parametrize("counts", [(1, 2), (2, 4), (8,)])
def test_plan_block_count_budget_identical(counts):
    dense = hetero_matrix(512)
    ours = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE, "ell"), dense, "latency",
                            block_counts=counts, cost_model=_cost_model())
    ref = ref_plan_partitioned(StubPredictor(REF_DEFAULT, "ell"), dense, "latency",
                               block_counts=counts)
    _assert_same_plan(ours, ref)
    assert ours.n_blocks <= max(counts)


def test_plan_with_the_plugin_registered_identical(with_bcsr):
    dense = hetero_matrix(512)
    for objective in ("latency", "efficiency"):
        ours = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), dense, objective,
                                cost_model=_cost_model())
        ref = ref_plan_partitioned(StubPredictor(REF_DEFAULT), dense, objective)
        _assert_same_plan(ours, ref)


def test_combine_identical():
    from repro.core.objectives import ObjectiveValues as RefOV

    parts = [(1e-6, 2e-9, 2e-3, 5.0), (3e-6, 1e-9, 3e-4, 7.0)]
    _assert_same_values(combine([ObjectiveValues(*p) for p in parts], 1e4),
                        ref_combine([RefOV(*p) for p in parts], 1e4))
    inf = combine([ObjectiveValues(*parts[0]),
                   ObjectiveValues(math.inf, math.inf, math.inf, 0.0, feasible=False)], 1e4)
    assert not inf.feasible


def test_default_cost_model_is_the_card_profile():
    """Without an injected model the planner scores on ``H100_SXM``."""
    dense = hetero_matrix(256)
    a = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), dense, "latency")
    b = plan_partitioned(StubPredictor(DEFAULT_SCHEDULE), dense, "latency", cost_model=CostModel())
    assert a.formats == b.formats and a.modeled.latency == b.modeled.latency


# ------------------------------------------------------------------- executor


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pattern", ["fem", "powerlaw"])
def test_sequential_executor_matches_reference(fmt, pattern):
    dense = random_matrix(160, 6.0, pattern, seed=11).astype(np.float32)
    x = _x(160, seed=1)
    ref_plan, plan = plan_pair(dense, [fmt], 3)
    y_ref = np.asarray(ref_compile_partitioned(dense, ref_plan)(x))
    kernel = compile_partitioned(dense, plan, device="cpu")
    y = kernel(x)
    assert isinstance(y, torch.Tensor) and y.shape == (160,)
    assert_scaled_close(y.numpy(), y_ref, 1e-4)
    assert_scaled_close(y.numpy(), dense.astype(np.float64) @ x, 1e-4)


def test_timed_call_warms_up_and_times_each_block():
    dense = hetero_matrix(256)
    _, plan = plan_pair(dense, ["csr", "ell", "bell", "sell"], 4)
    kernel = compile_partitioned(dense, plan, device="cpu")
    assert kernel.formats == ("csr", "ell", "bell", "sell") and kernel.n_blocks == 4
    x = _x(256, seed=5)
    y, times = kernel.timed_call(x)
    assert kernel._warmed and len(times) == 4 and all(t > 0 for t in times)
    np.testing.assert_allclose(y, kernel(x).numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        PartitionedSpmv([], 0)


# -------------------------------------------------------------------- session


@pytest.mark.parametrize("fused", [False, True])
def test_session_partitioned_optimize_identical(fused):
    clear_kernel_memo()
    dense = hetero_matrix(512)
    x = _x(512)
    ours_t, ref_t = _tuners()
    ours = AutoSpmvSession(ours_t, cost_model=_cost_model())
    ref = RefSession(ref_t)
    ra, rb = ours.partitioned_optimize(dense, fused=fused), ref.partitioned_optimize(dense, fused=fused)
    assert isinstance(ra, PartitionedResult) and not ra.cache_hit
    _assert_same_plan(ra.plan, rb.plan)
    assert (ra.fingerprint, ra.bucket, ra.mode) == (rb.fingerprint, rb.bucket, rb.mode)
    assert ra.kernel.formats == rb.kernel.formats and ra.n_blocks == rb.n_blocks
    y, y_ref = ra.kernel(x).numpy(), np.asarray(rb.kernel(x))
    assert_scaled_close(y, y_ref, 1e-4)
    assert_scaled_close(y, dense.astype(np.float64) @ x, 1e-4)
    # a repeat is a cache hit that compiles nothing
    ra2, rb2 = ours.partitioned_optimize(dense, fused=fused), ref.partitioned_optimize(dense, fused=fused)
    assert ra2.cache_hit and rb2.cache_hit
    keys = ("requests", "plans_computed", "kernel_compiles", "cache_hits", "cache_misses",
            "feature_extractions")
    assert {k: ours.stats.as_dict()[k] for k in keys} == {k: ref.stats.as_dict()[k] for k in keys}
    # the cached entries carry the same decisions
    (ea,), (eb,) = list(ours.cache.entries()), list(ref.cache.entries())
    assert (ea.fmt, ea.mode, ea.n_blocks, ea.monolithic_fmt, ea.schedule) == (
        eb.fmt, eb.mode, eb.n_blocks, eb.monolithic_fmt, eb.schedule)
    assert [dict(b, latency=0) for b in ea.blocks] == [dict(b, latency=0) for b in eb.blocks]
    clear_kernel_memo()


def test_session_cache_json_replays_onto_a_bucket_mate(tmp_path):
    """A fresh session replays the saved composite decisions — in both
    directions across the packages — onto a bucket-mate's own boundaries."""
    dense = hetero_matrix(512)
    ours_t, ref_t = _tuners()
    first = AutoSpmvSession(ours_t, cost_model=_cost_model())
    r1 = first.partitioned_optimize(dense)
    path = first.save(tmp_path / "ours.json")
    mate = 1.5 * dense  # other values, same pattern: a bucket-mate
    row = mate[300]
    nz = np.flatnonzero(row)
    row[nz[0]], row[nz[0] - 1 if nz[0] else nz[0] + 1] = 0.0, 2.0  # one entry moved
    assert int((mate != 0).sum()) == int((dense != 0).sum())
    warm = AutoSpmvSession(ours_t, cache=TuningCache.load(path))
    r2 = warm.partitioned_optimize(mate)
    assert r2.bucket == r1.bucket and r2.cache_hit and warm.stats.plans_computed == 0
    assert r2.plan.formats == r1.plan.formats and r2.n_blocks == r1.n_blocks
    assert r2.plan.partition.boundaries() == partition_rows(mate, r1.n_blocks).boundaries()
    assert_scaled_close(r2.kernel(_x(512)).numpy(), mate.astype(np.float64) @ _x(512), 1e-4)
    # the reference replays the port's file, and the port the reference's
    from repro.core.cache import TuningCache as RefCache

    rr = RefSession(ref_t, cache=RefCache.load(path)).partitioned_optimize(mate)
    assert rr.cache_hit and rr.plan.formats == r2.plan.formats
    ref_path = tmp_path / "ref.json"
    ref_sess = RefSession(ref_t)
    ref_sess.partitioned_optimize(dense)
    ref_sess.save(ref_path)
    back = AutoSpmvSession(ours_t, cache=TuningCache.load(ref_path)).partitioned_optimize(mate)
    assert back.cache_hit and back.plan.formats == r2.plan.formats
    assert json.loads(path.read_text()).keys() == json.loads(ref_path.read_text()).keys()


def test_session_partition_mode_keyed_by_budget():
    dense = hetero_matrix(512)
    ours_t, ref_t = _tuners()
    session = AutoSpmvSession(ours_t, cost_model=_cost_model())
    ref = RefSession(ref_t)
    r8, r2 = session.partitioned_optimize(dense, max_blocks=8), session.partitioned_optimize(dense, max_blocks=2)
    assert (r8.mode, r2.mode) == ("part:max8", "part:max2") and r2.n_blocks <= 2
    assert r2.plan.formats == ref.partitioned_optimize(dense, max_blocks=2).plan.formats
    assert r8.plan.formats == ref.partitioned_optimize(dense, max_blocks=8).plan.formats
    assert len(session.cache) == 2


def test_serve_and_observe_partitioned_without_and_with_telemetry():
    dense = hetero_matrix(256)
    ours_t, _ = _tuners()
    session = AutoSpmvSession(ours_t, cost_model=_cost_model())
    res = session.serve_partitioned(dense)  # no selector: exactly partitioned_optimize
    assert res.served_formats == () and res.exploratory == ()
    assert res.formats == res.plan.formats
    session.observe_partitioned(res, [1e-3] * res.n_blocks)
    assert session.stats.observations == 1
    with pytest.raises(ValueError):
        session.observe_partitioned(res, [1e-3] * (res.n_blocks + 1))
    with pytest.raises(NotImplementedError, match="telemetry"):
        AutoSpmvSession(ours_t, adaptive=object()).serve_partitioned(dense)
    with pytest.raises(NotImplementedError, match="telemetry"):
        AutoSpmvSession(ours_t, telemetry=object()).observe_partitioned(res, [1e-3] * res.n_blocks)


def test_sharded_executor_belongs_to_a_later_slice():
    import repro_torch.partition as part

    for name in ("ShardedPartitionedSpmv", "shard_partitioned"):
        assert not hasattr(part, name)  # no silent stand-in
        with pytest.raises(ImportError):
            exec(f"from repro_torch.partition import {name}", {})


# --------------------------------------------------------------- server + CLI


@pytest.mark.parametrize("fused", [False, True])
def test_server_partitioned_matches_reference_server(fused):
    mats = [hetero_matrix(256), random_matrix(200, 6.0, "fem", seed=2).astype(np.float32)]
    picks = [0, 1, 0, 1, 0]
    xs = [_x(mats[i].shape[1], seed=j) for j, i in enumerate(picks)]
    ours_t, ref_t = _tuners()
    ours = SpmvServer(AutoSpmvSession(ours_t, cost_model=_cost_model()), partition=True,
                      fused=fused)
    ref = RefServer(RefSession(ref_t), partition=True, fused=fused)
    done = ours.run([SpmvRequest(rid=j, dense=mats[i], x=xs[j]) for j, i in enumerate(picks)])
    ref_done = ref.run([RefRequest(rid=j, dense=mats[i], x=xs[j]) for j, i in enumerate(picks)])
    for a, b in zip(done, ref_done):
        assert (a.fmt, a.cache_hit, a.schedule.as_dict()) == (b.fmt, b.cache_hit, b.schedule.as_dict())
        tol = tol_for(a.schedule.accum_dtype)
        assert_scaled_close(a.y, b.y, tol)
        assert_scaled_close(a.y, a.dense.astype(np.float64) @ a.x, tol)
    assert [r.cache_hit for r in done] == [False, False, True, True, True]
    assert ours.session.stats.plans_computed == 2
    summary = ours.summary()  # the metrics registry is per process: counts accumulate
    assert summary["requests"] == 5 and summary["latency"]["latency"]["count"] >= 5
    assert set(summary["energy"]) >= {r.fmt for r in done}


def test_cli_partition_fused_with_the_plugin_on_the_cpu(with_bcsr, tmp_path):
    from repro_torch.launch.serve import main

    cache = tmp_path / "t.json"
    done = main(["--spmv", "--device", "cpu", "--requests", "6", "--partition", "--fused",
                 "--format-plugins", "repro_torch.sparse.bcsr", "--spmv-cache", str(cache)])
    assert len(done) == 6 and cache.exists()
    for r in done:
        tol = 3e-2 if r.schedule.accum_dtype == "bfloat16" else 1e-4
        assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol)
    assert "part:max8" in cache.read_text()  # the composite plans persisted
