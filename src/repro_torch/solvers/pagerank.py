"""Damped PageRank over the served SpMV plan.

Power-method PageRank on a column-stochastic transition matrix ``P``::

    r' = d * (P r + dangling_mass * v) + (1 - d) * v

where ``v`` is the (uniform by default) teleport distribution and
``dangling_mass = sum(r[j] for dangling j)`` redistributes the rank that
zero-out-degree nodes (dangling columns of ``P``) would otherwise leak —
the textbook fix that keeps ``sum(r) == 1`` exactly. Convergence is the L1
change between successive rank vectors, the standard PageRank criterion.

The multiplied operator is ``P`` (column-normalized), so callers can hand
either a raw adjacency matrix (``normalize=True``, the default, routes it
through ``sparse.generate.normalize_columns``) or an already-stochastic
one.
"""

from __future__ import annotations

import numpy as np

from repro_torch.solvers.adaptive import AdaptiveSpmvPolicy
from repro_torch.solvers.iterate import IterativeSolver, SolveResult


def pagerank_reference(
    dense: np.ndarray,
    damping: float = 0.85,
    tol: float = 1e-10,
    max_iters: int = 500,
) -> np.ndarray:
    """Dense-NumPy oracle: same recurrence, no kernels. For tests/benches."""
    from repro_torch.sparse.generate import normalize_columns

    P = normalize_columns(np.asarray(dense, dtype=np.float64))
    n = P.shape[0]
    dangling = P.sum(axis=0) == 0
    v = np.full(n, 1.0 / n)
    r = v.copy()
    for _ in range(max_iters):
        r_next = damping * (P @ r + r[dangling].sum() * v) + (1.0 - damping) * v
        if np.abs(r_next - r).sum() <= tol:
            return r_next
        r = r_next
    return r


def pagerank(
    session,
    dense: np.ndarray,
    *,
    damping: float = 0.85,
    tol: float = 1e-8,
    max_iters: int = 100,
    policy: AdaptiveSpmvPolicy | None = None,
    normalize: bool = True,
    personalization: np.ndarray | None = None,
    x0: np.ndarray | None = None,
    objective: str = "latency",
) -> SolveResult:
    """Damped PageRank through one served plan; returns ranks summing to 1."""
    from repro_torch.sparse.generate import normalize_columns

    A = np.asarray(dense, dtype=np.float32)
    P = normalize_columns(A) if normalize else A
    n = P.shape[0]
    dangling = np.flatnonzero(P.sum(axis=0) == 0)
    if personalization is None:
        v = np.full(n, 1.0 / n, dtype=np.float32)
    else:
        v = np.asarray(personalization, dtype=np.float32)
        v = v / v.sum()
    r0 = v.copy() if x0 is None else np.asarray(x0, dtype=np.float32)
    driver = IterativeSolver(
        session,
        P,
        name="pagerank",
        objective=objective,
        tol=tol,
        max_iters=max_iters,
        policy=policy,
    )

    def step(matvec, r):
        leak = float(r[dangling].sum()) if dangling.size else 0.0
        r_next = damping * (matvec(r) + leak * v) + (1.0 - damping) * v
        return r_next, float(np.abs(r_next - r).sum())

    return driver.solve(
        r0,
        step,
        extras=lambda r: {
            "damping": damping,
            "dangling_nodes": int(dangling.size),
            "rank_sum": float(np.sum(r)),
        },
    )
