"""Generic iterative-solve driver over an ``AutoSpmvSession``.

This is where the paper's §5.3 amortization argument becomes a measured
fact: ``setup()`` calls ``serve_optimize`` exactly ONCE per solve, and the
iteration loop replays the cached ``PreparedSpmv`` (plus, when the adaptive
policy routes a sparse frontier, the lazily-compiled SpMSpV twin) — the
session's ``plans_computed`` / ``kernel_compiles`` counters stay flat while
``observe()`` feeds every iteration's wall time back into the telemetry
bandit. Each iteration runs inside a nested ``solver.iterate`` span and
bumps ``solver_iterations_total``, so a trace of a 50-iteration solve shows
one ``session.optimize`` and fifty iterate spans under ``solver.solve``.

Solvers (``pagerank`` / ``cg`` / ``power``) express one iteration as a
``step(matvec, state) -> (state, residual)`` callable and hand the loop to
``solve``; the driver owns convergence, timing, spans, and the SpMV↔SpMSpV
routing so every solver gets them identically.

Solver state lives on the host in numpy, as in the reference; each matvec
copies its input to the session's device (the dense x for SpMV, the
frontier's indices and values for SpMSpV), runs the kernel, waits on the
kernel's stream, and copies y back. The measured matvec time covers the
input copy, the launch and the wait, not the copy of y.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.common import KernelSchedule
from repro_torch.kernels.ops import compile_spmv
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.trace import span as _span
from repro_torch.solvers.adaptive import SPMSPV, AdaptiveSpmvPolicy
from repro_torch.utils.logging import get_logger

log = get_logger("solvers.iterate")


def _wait(y: torch.Tensor) -> torch.Tensor:
    """Block until the kernel that produced ``y`` has finished (a CPU
    tensor is complete when the call returns)."""
    if y.is_cuda:
        torch.cuda.current_stream(y.device).synchronize()
    return y


@dataclass
class SolveResult:
    """Structured outcome of one iterative solve."""

    solver: str
    value: np.ndarray  # the converged vector (ranks / solution / eigvec)
    iterations: int
    converged: bool
    residual: float  # final residual
    residuals: list[float]  # per-iteration residual history
    iteration_seconds: list[float]  # wall time per iteration (step incl. matvec)
    matvec_seconds: list[float]  # wall time of the kernel calls alone
    matvec_kinds: list[str]  # "spmv" | "spmspv" per matvec
    spmv_calls: int
    spmspv_calls: int
    modeled_work: int  # stored nonzeros actually touched across the solve
    spmv_work_equiv: int  # matvecs * nnz(A): the always-SpMV comparator
    plan_id: str = ""
    fmt: str = ""
    cache_hit: bool = False
    extras: dict = field(default_factory=dict)  # solver-specific scalars

    def iter_p50_s(self) -> float:
        if not self.iteration_seconds:
            return 0.0
        return float(np.median(self.iteration_seconds))

    def summary(self) -> dict:
        """JSON-ready convergence metadata (the ``launch.solve`` payload)."""
        return {
            "solver": self.solver,
            "iterations": self.iterations,
            "converged": self.converged,
            "residual": self.residual,
            "iter_p50_s": self.iter_p50_s(),
            "total_s": float(sum(self.iteration_seconds)),
            "spmv_calls": self.spmv_calls,
            "spmspv_calls": self.spmspv_calls,
            "modeled_work": self.modeled_work,
            "spmv_work_equiv": self.spmv_work_equiv,
            "plan_id": self.plan_id,
            "fmt": self.fmt,
            "cache_hit": self.cache_hit,
            **{k: v for k, v in self.extras.items()},
        }


class IterativeSolver:
    """Drives ``y = A @ x`` loops through one served Auto-SpMV plan.

    Parameters
    ----------
    session:
        The ``AutoSpmvSession`` that owns planning, caching, and telemetry.
    dense:
        The matrix actually multiplied each iteration (solvers pass the
        normalized / symmetrized operator, not the raw generator output).
    policy:
        Optional ``AdaptiveSpmvPolicy``; without one every matvec is SpMV.
    force_fp32:
        Solvers promise 1e-5 agreement with dense NumPy references, so a
        served plan whose schedule accumulates in bf16 is recompiled with
        ``accum_dtype="float32"`` (same format, same memo identity modulo
        schedule) before iterating. Set False to take the plan verbatim.
    """

    def __init__(
        self,
        session,
        dense: np.ndarray,
        *,
        name: str = "solver",
        objective: str = "latency",
        tol: float = 1e-8,
        max_iters: int = 100,
        policy: AdaptiveSpmvPolicy | None = None,
        force_fp32: bool = True,
    ):
        self.session = session
        self.dense = np.asarray(dense, dtype=np.float32)
        self.name = name
        self.objective = objective
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.policy = policy
        self.force_fp32 = force_fp32
        self.nnz = int((self.dense != 0).sum())
        self.n_cols = int(self.dense.shape[1])
        self.plan = None
        self._spmv_kernel = None
        self._spmspv_kernel = None  # lazily compiled on first sparse frontier
        self.matvec_seconds: list[float] = []
        self.matvec_kinds: list[str] = []
        self.modeled_work = 0

    # -------------------------------------------------------------- planning
    def setup(self):
        """Serve the ONE plan this whole solve amortizes; idempotent."""
        if self.plan is not None:
            return self.plan
        plan = self.session.serve_optimize(self.dense, self.objective)
        kernel = plan.kernel
        if self.force_fp32 and plan.schedule.accum_dtype != "float32":
            sched = plan.schedule.replace(accum_dtype="float32")
            kernel = compile_spmv(
                self.dense,
                plan.fmt,
                sched,
                device=self.session.tuner.device,
                memo_key=plan.fingerprint,
            )
            log.info(
                "solver %s: plan schedule accumulates in %s; recompiled fp32",
                self.name,
                plan.schedule.accum_dtype,
            )
        self.plan = plan
        self._spmv_kernel = kernel
        if self.policy is not None:
            # scope the phase-bandit cells to this plan's matrix family
            self.policy.bucket = plan.bucket
            self.policy.objective = plan.objective
        return plan

    def _iter_schedule(self) -> KernelSchedule:
        sched = self.plan.schedule
        if self.force_fp32 and sched.accum_dtype != "float32":
            sched = sched.replace(accum_dtype="float32")
        return sched

    # --------------------------------------------------------------- matvec
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """One ``A @ x`` through the served plan, routed by frontier density.

        SpMV iterations feed ``session.observe`` (the format bandit's
        signal); SpMSpV iterations feed only the policy's phase cell —
        crediting a sparse-frontier time to a dense-SpMV arm would corrupt
        the format statistics.
        """
        self.setup()
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
        active = np.flatnonzero(x).astype(np.int32)
        density = active.size / max(self.n_cols, 1)
        decision = self.policy.choose(density) if self.policy is not None else None
        if decision is not None and decision.kind == SPMSPV:
            kernel = self._ensure_spmspv()
            t0 = perf_counter()
            y = _wait(kernel.call_frontier(active, x[active]))
            dt = perf_counter() - t0
            self.modeled_work += kernel.modeled_work(active)
        else:
            t0 = perf_counter()
            y = _wait(self._spmv_kernel(x))  # PreparedSpmv copies x to its device
            dt = perf_counter() - t0
            self.modeled_work += self.nnz
            self.session.observe(self.plan, dt)
        kind = decision.kind if decision is not None else "spmv"
        if decision is not None:
            self.policy.update(decision, dt)
        self.matvec_seconds.append(dt)
        self.matvec_kinds.append(kind)
        return y.cpu().numpy().astype(np.float32, copy=False)

    def _ensure_spmspv(self):
        if self._spmspv_kernel is None:
            self._spmspv_kernel = self.session.compile_spmspv(
                self.dense, self._iter_schedule()
            )
        return self._spmspv_kernel

    # ----------------------------------------------------------------- loop
    def solve(
        self,
        state: Any,
        step: Callable[[Callable, Any], tuple[Any, float]],
        value: Callable[[Any], np.ndarray] | None = None,
        extras: Callable[[Any], dict] | None = None,
    ) -> SolveResult:
        """Iterate ``step`` to convergence under spans/metrics/accounting."""
        self.setup()
        metrics = get_metrics()
        iters_total = metrics.counter("solver_iterations_total", solver=self.name)
        iter_hist = metrics.histogram("solver_iteration_seconds", solver=self.name)
        residuals: list[float] = []
        iter_seconds: list[float] = []
        converged = False
        it = 0
        with _span("solver.solve", solver=self.name, max_iters=self.max_iters):
            for it in range(1, self.max_iters + 1):
                t0 = perf_counter()
                with _span("solver.iterate", solver=self.name, iteration=it):
                    state, res = step(self.matvec, state)
                dt = perf_counter() - t0
                iters_total.inc()
                iter_hist.observe(dt)
                residuals.append(float(res))
                iter_seconds.append(dt)
                if res <= self.tol:
                    converged = True
                    break
        kinds = self.matvec_kinds
        result = SolveResult(
            solver=self.name,
            value=np.asarray(value(state) if value is not None else state),
            iterations=it,
            converged=converged,
            residual=residuals[-1] if residuals else float("inf"),
            residuals=residuals,
            iteration_seconds=iter_seconds,
            matvec_seconds=list(self.matvec_seconds),
            matvec_kinds=list(kinds),
            spmv_calls=sum(1 for k in kinds if k != SPMSPV),
            spmspv_calls=sum(1 for k in kinds if k == SPMSPV),
            modeled_work=self.modeled_work,
            spmv_work_equiv=len(kinds) * self.nnz,
            plan_id=self.plan.plan_id,
            fmt=self.plan.fmt,
            cache_hit=self.plan.cache_hit,
            extras=extras(state) if extras is not None else {},
        )
        log.info(
            "%s: %d iters, converged=%s, residual=%.3g, spmv=%d spmspv=%d",
            self.name,
            result.iterations,
            result.converged,
            result.residual,
            result.spmv_calls,
            result.spmspv_calls,
        )
        return result
