"""Iterative solvers, port vs reference: PageRank, CG and power iteration
through sessions built on the reference solver tests' fake predictor and
overhead model (injected into each package's ``AutoSpMV``), with and
without the adaptive SpMV↔SpMSpV policy; the one-plan amortization
contract; the ``force_fp32`` guard; and the ``launch.solve`` CLI of both
packages on the same arguments. The reference runs its kernels in interpret
mode, the port its plain versions on the CPU."""

import json

import numpy as np
import pytest

from repro.core import AutoSpMV as RefAutoSpMV
from repro.core import AutoSpmvSession as RefSession
from repro.kernels import ops as ref_ops
from repro.kernels.common import KernelSchedule as RefSchedule
from repro.launch import solve as ref_solve
from repro.solvers import AdaptiveSpmvPolicy as RefPolicy
from repro.solvers import IterativeSolver as RefIterativeSolver
from repro.solvers import cg as ref_cg
from repro.solvers import pagerank as ref_pagerank
from repro.solvers import power_iteration as ref_power
from repro.solvers.pagerank import pagerank_reference as ref_pagerank_reference
from repro.sparse.generate import generate_by_name, random_matrix
from repro.telemetry import AdaptiveFormatSelector as RefSelector
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels import ops
from repro_torch.kernels.common import KernelSchedule
from repro_torch.kernels.spmspv import csc_spmspv
from repro_torch.launch import solve as launch_solve
from repro_torch.obs.trace import get_tracer
from repro_torch.solvers import (
    AdaptiveSpmvPolicy,
    IterativeSolver,
    SolveResult,
    cg,
    pagerank,
    power_iteration,
)
from repro_torch.solvers.adaptive import SPMSPV, SPMV
from repro_torch.solvers.pagerank import pagerank_reference
from repro_torch.telemetry import AdaptiveFormatSelector

from test_solvers import WEB_SCALE, _FakeOverhead, _FakePredictor, _spd
from torch_port_helpers import traced  # noqa: F401  (a fixture)


def _sessions(schedule_kw=None):
    """(port, reference) sessions around the reference tests' fakes."""
    kw = schedule_kw or {}
    ours = AutoSpmvSession(AutoSpMV(_FakePredictor(KernelSchedule(**kw)), _FakeOverhead(),
                                    device="cpu"))
    ref = RefSession(RefAutoSpMV(_FakePredictor(RefSchedule(**kw)), _FakeOverhead()))
    return ours, ref


@pytest.fixture
def clean():
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    yield
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()


@pytest.fixture
def same_clock(monkeypatch):
    """Both solver loops read a clock that ticks 1 ms per call. The UCB
    phase bandit learns from measured matvec times, which differ between an
    interpret-mode reference and the port; with the same clock both packages
    see the same times, so their routing must agree exactly."""
    import repro.solvers.iterate as ref_iterate
    import repro_torch.solvers.iterate as iterate

    for mod in (ref_iterate, iterate):
        ticks = iter(range(10**9))
        monkeypatch.setattr(mod, "perf_counter", lambda t=ticks: next(t) * 1e-3)


@pytest.fixture(scope="module")
def web():
    return generate_by_name("webgraph", scale=WEB_SCALE)


def _policies(adaptive: str):
    """(port, reference) policies: none, the threshold rule, or the rule
    under the UCB phase bandit."""
    if adaptive == "none":
        return None, None
    if adaptive == "threshold":
        return AdaptiveSpmvPolicy(), RefPolicy()
    return AdaptiveSpmvPolicy(selector=AdaptiveFormatSelector()), RefPolicy(selector=RefSelector())


def _assert_same_solve(ours: SolveResult, ref, value_tol=1e-5):
    assert isinstance(ours, SolveResult)
    assert (ours.iterations, ours.converged) == (ref.iterations, ref.converged)
    assert ours.matvec_kinds == ref.matvec_kinds
    assert (ours.spmv_calls, ours.spmspv_calls) == (ref.spmv_calls, ref.spmspv_calls)
    assert (ours.modeled_work, ours.spmv_work_equiv) == (ref.modeled_work, ref.spmv_work_equiv)
    assert (ours.plan_id, ours.fmt, ours.cache_hit) == (ref.plan_id, ref.fmt, ref.cache_hit)
    assert np.abs(np.asarray(ours.value) - np.asarray(ref.value)).max() <= value_tol
    np.testing.assert_allclose(ours.residuals, ref.residuals, rtol=1e-5)
    assert sorted(ours.summary()) == sorted(ref.summary())
    assert len(ours.matvec_seconds) == len(ours.matvec_kinds) == len(ref.matvec_kinds)


# -------------------------------------------------------------- the solvers
@pytest.mark.parametrize("adaptive", ["none", "threshold", "bandit"])
@pytest.mark.parametrize("personalized", [False, True])
def test_pagerank_equals_reference(clean, same_clock, web, personalized, adaptive):
    ours_s, ref_s = _sessions()
    pol, ref_pol = _policies(adaptive)
    kw = dict(tol=1e-9, max_iters=30)
    if personalized:  # one non-dangling seed: early frontiers are sparse
        seed = int(np.flatnonzero(web.sum(axis=0) > 0)[0])
        p = np.zeros(web.shape[0], np.float32)
        p[seed] = 1.0
        kw["personalization"] = p
    ref = ref_pagerank(ref_s, web, policy=ref_pol, **kw)
    ours = pagerank(ours_s, web, policy=pol, **kw)
    _assert_same_solve(ours, ref)
    assert ours.extras.keys() == ref.extras.keys()
    assert abs(ours.extras["rank_sum"] - 1.0) < 1e-5
    assert ours.extras["dangling_nodes"] == ref.extras["dangling_nodes"] > 0
    if personalized and adaptive != "none":
        assert ours.spmspv_calls >= 1  # the sparse start went through SpMSpV


def test_pagerank_reference_oracle_equal(web):
    np.testing.assert_allclose(pagerank_reference(web, tol=1e-12),
                               ref_pagerank_reference(web, tol=1e-12), rtol=0, atol=0)


@pytest.mark.parametrize("adaptive", ["none", "threshold", "bandit"])
def test_cg_equals_reference(clean, same_clock, adaptive):
    ours_s, ref_s = _sessions()
    pol, ref_pol = _policies(adaptive)
    S = _spd()
    b = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    ref = ref_cg(ref_s, S, b, tol=1e-10, max_iters=200, policy=ref_pol)
    ours = cg(ours_s, S, b, tol=1e-10, max_iters=200, policy=pol)
    _assert_same_solve(ours, ref)
    assert ours.converged
    if adaptive != "bandit":  # the bandit may explore SpMSpV; the prior never does
        assert ours.spmspv_calls == 0  # p is dense from iteration 0
    x_ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    assert np.abs(ours.value - x_ref).max() < 1e-5


def test_cg_with_x0_equals_reference(clean):
    ours_s, ref_s = _sessions()
    S = _spd(n=96, seed=4)
    b = np.random.default_rng(2).standard_normal(96).astype(np.float32)
    x0 = np.random.default_rng(3).standard_normal(96)
    _assert_same_solve(cg(ours_s, S, b, x0=x0, tol=1e-9, max_iters=100),
                       ref_cg(ref_s, S, b, x0=x0, tol=1e-9, max_iters=100))


@pytest.mark.parametrize("adaptive", ["none", "threshold", "bandit"])
def test_power_iteration_equals_reference(clean, same_clock, web, adaptive):
    ours_s, ref_s = _sessions()
    pol, ref_pol = _policies(adaptive)
    ref = ref_power(ref_s, web, tol=0.0, max_iters=12, policy=ref_pol)
    ours = power_iteration(ours_s, web, tol=0.0, max_iters=12, policy=pol)
    _assert_same_solve(ours, ref)
    assert ours.extras["eigenvalue"] == pytest.approx(ref.extras["eigenvalue"], rel=1e-5)
    if pol is not None:
        assert pol.kinds() == ref_pol.kinds()
        assert [d.phase for d in pol.decisions] == [d.phase for d in ref_pol.decisions]


def test_adaptive_policy_flips_one_way(clean, web):
    ours_s, _ = _sessions()
    pol = AdaptiveSpmvPolicy()
    res = power_iteration(ours_s, web, tol=0.0, max_iters=12, policy=pol)
    kinds = res.matvec_kinds
    assert kinds[0] == SPMSPV and SPMV in kinds
    flip = kinds.index(SPMV)
    assert all(k == SPMSPV for k in kinds[:flip])
    assert all(k == SPMV for k in kinds[flip:]), "flip must be one-way"
    assert res.modeled_work < res.spmv_work_equiv
    # SpMSpV iterations feed only the policy, SpMV iterations the session
    assert ours_s.stats.observations == res.spmv_calls
    # the SpMSpV twin was compiled once, lazily, and booked by the session
    assert ours_s.stats.kernel_compiles == 2


# ------------------------------------------------------ amortization contract
def test_fifty_iteration_solve_plans_exactly_once(clean, traced, web):
    ours_s, _ = _sessions()
    tracer = get_tracer()
    tracer.clear()
    res = power_iteration(ours_s, web, tol=0.0, max_iters=50)
    assert res.iterations == 50
    assert ours_s.stats.plans_computed == 1
    assert ours_s.stats.observations == 50
    iterate = [s for s in tracer.spans() if s["name"] == "solver.iterate"]
    assert len(iterate) == 50
    assert {s["attrs"]["iteration"] for s in iterate} == set(range(1, 51))
    assert all(s["attrs"]["solver"] == "power" for s in iterate)
    assert len([s for s in tracer.spans() if s["name"] == "solver.solve"]) == 1
    res2 = power_iteration(ours_s, web, tol=0.0, max_iters=5)
    assert ours_s.stats.plans_computed == 1 and res2.cache_hit


def test_force_fp32_recompiles_bf16_plans_like_the_reference(clean, web):
    ours_s, ref_s = _sessions(dict(accum_dtype="bfloat16"))
    solver = IterativeSolver(ours_s, web, name="guard")
    ref_solver = RefIterativeSolver(ref_s, web, name="guard")
    plan, ref_plan = solver.setup(), ref_solver.setup()
    assert plan.schedule.accum_dtype == ref_plan.schedule.accum_dtype == "bfloat16"
    assert solver._spmv_kernel.schedule.as_dict() == ref_solver._spmv_kernel.schedule.as_dict()
    assert solver._spmv_kernel.schedule.accum_dtype == "float32"
    assert solver._spmv_kernel.device.type == "cpu"
    x = np.random.default_rng(1).standard_normal(web.shape[1]).astype(np.float32)
    y = solver.matvec(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    ref = web.astype(np.float64) @ x.astype(np.float64)
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-5
    np.testing.assert_allclose(y, ref_solver.matvec(x), rtol=1e-6, atol=1e-6)
    # without the guard the plan's bf16 schedule is taken verbatim
    raw = IterativeSolver(ours_s, web, name="raw", force_fp32=False)
    raw.setup()
    assert raw._spmv_kernel.schedule.accum_dtype == "bfloat16"


def test_matvec_routes_and_counts_on_the_cpu(clean, web):
    """The SpMSpV branch hands the frontier to the twin kernel; on the CPU
    that is the plain version, and no launch is counted."""
    ours_s, _ = _sessions()
    solver = IterativeSolver(ours_s, web, policy=AdaptiveSpmvPolicy())
    x = np.zeros(web.shape[1], np.float32)
    x[[3, 17]] = (1.0, -2.0)
    before = csc_spmspv.launches
    y = solver.matvec(x)
    np.testing.assert_allclose(y, web.astype(np.float64) @ x, rtol=1e-6, atol=1e-6)
    assert solver.matvec_kinds == [SPMSPV] and csc_spmspv.launches == before
    assert solver.modeled_work == int((web[:, [3, 17]] != 0).sum())
    dense_x = np.ones(web.shape[1], np.float32)
    solver.matvec(dense_x)
    assert solver.matvec_kinds == [SPMSPV, SPMV]


# ----------------------------------------------------------------- the CLI
def test_spd_operator_and_resolve_matrix_equal_reference():
    for name, scale in (("webgraph", WEB_SCALE), ("fem", 0.0006), ("rim", 0.0008)):
        a = launch_solve.resolve_matrix(name, scale, seed=1)
        b = ref_solve.resolve_matrix(name, scale, seed=1)
        np.testing.assert_array_equal(a, b)
    A = random_matrix(64, 5.0, "powerlaw", seed=3)
    np.testing.assert_array_equal(launch_solve.spd_operator(A), ref_solve.spd_operator(A))
    with pytest.raises(SystemExit):
        launch_solve.resolve_matrix("nope", 0.001, 0)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("solver", ["pagerank", "cg", "power"])
def test_cli_equals_reference_cli(clean, same_clock, tmp_path, solver, adaptive):
    args = ["--solver", solver, "--matrix", "webgraph", "--scale", str(WEB_SCALE),
            "--max-iters", "8", "--train-matrices", "2"]
    if adaptive:
        args.append("--adaptive-spmspv")
    ref = ref_solve.main(args + ["--json-out", str(tmp_path / "ref.json")])
    ours = launch_solve.main(args + ["--device", "cpu", "--json-out", str(tmp_path / "ours.json"),
                                     "--metrics-export", str(tmp_path / "m.jsonl"),
                                     "--trace-export", str(tmp_path / "t.jsonl")])
    a = json.loads((tmp_path / "ours.json").read_text())
    b = json.loads((tmp_path / "ref.json").read_text())
    assert sorted(a) == sorted(b) and sorted(a["session"]) == sorted(b["session"])
    for key in ("matrix", "n", "nnz", "iterations", "converged", "spmv_calls", "spmspv_calls",
                "modeled_work", "spmv_work_equiv", "adaptive_spmspv"):
        assert a[key] == b[key], key
    assert ours.matvec_kinds == ref.matvec_kinds
    assert a["session"]["plans_computed"] == 1
    assert (tmp_path / "m.jsonl").exists() and (tmp_path / "t.jsonl").exists()


def test_cli_refuses_the_cpu_unless_asked():
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_solve.main(["--solver", "power", "--scale", str(WEB_SCALE), "--max-iters", "1"])
