"""Power iteration over the served plan — the frontier-densification probe.

Plain normalized power iteration toward the dominant eigenpair. Started
from a single seed coordinate (the default), the iterate's support is the
seed's k-hop out-neighborhood: it grows from one entry toward (near-)dense
across iterations, which is exactly the input-sparsity trajectory the
SpMV↔SpMSpV policy exists for — early iterations are SpMSpV wins, late
ones SpMV. The solver truncates entries below ``prune_tol`` after
normalization so the frontier stays *genuinely* sparse until mixing
actually spreads mass (fp32 rounding would otherwise densify it in one
step) — the standard push-style tolerance from frontier PageRank/BFS.

Residual: ``||A x - λ x||₂ / |λ|`` with λ the Rayleigh quotient.
"""

from __future__ import annotations

import numpy as np

from repro_torch.solvers.adaptive import AdaptiveSpmvPolicy
from repro_torch.solvers.iterate import IterativeSolver, SolveResult


def power_iteration(
    session,
    dense: np.ndarray,
    *,
    tol: float = 1e-6,
    max_iters: int = 100,
    policy: AdaptiveSpmvPolicy | None = None,
    x0: np.ndarray | None = None,
    seed_index: int = 0,
    prune_tol: float = 1e-7,
    objective: str = "latency",
) -> SolveResult:
    """Dominant eigenpair by power iteration; value is the unit eigenvector,
    ``extras["eigenvalue"]`` the Rayleigh estimate."""
    A = np.asarray(dense, dtype=np.float32)
    n = A.shape[0]
    if x0 is None:
        x = np.zeros(n, dtype=np.float64)
        x[seed_index % n] = 1.0
    else:
        x = np.asarray(x0, dtype=np.float64)
        x = x / (np.linalg.norm(x) or 1.0)
    driver = IterativeSolver(
        session,
        A,
        name="power",
        objective=objective,
        tol=tol,
        max_iters=max_iters,
        policy=policy,
    )

    # state = (x, lam)
    def step(matvec, state):
        x, _ = state
        y = matvec(x).astype(np.float64)
        lam = float(x @ y)  # Rayleigh quotient (x is unit-norm)
        norm = float(np.linalg.norm(y))
        if norm == 0.0:  # seed hit a sink; restart dense to keep iterating
            y = np.full(n, 1.0 / np.sqrt(n))
            norm = 1.0
        x_next = y / norm
        if prune_tol > 0:
            x_next = np.where(np.abs(x_next) >= prune_tol, x_next, 0.0)
            renorm = float(np.linalg.norm(x_next)) or 1.0
            x_next = x_next / renorm
        res = float(np.linalg.norm(y - lam * x)) / (abs(lam) or 1.0)
        return (x_next, lam), res

    return driver.solve(
        (x, 0.0),
        step,
        value=lambda s: s[0],
        extras=lambda s: {"eigenvalue": s[1]},
    )
