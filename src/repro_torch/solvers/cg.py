"""Conjugate gradient for SPD systems over the served SpMV plan.

Textbook CG (Hestenes–Stiefel): one ``A @ p`` per iteration — the SpMV
amortization shape exactly — plus vector work done host-side in float64 so
the recurrences stay numerically honest while the kernel runs the served
schedule. Convergence is the relative residual ``||b - A x|| / ||b||``,
tracked by the recurrence residual and trusted because fp32 accumulation
is forced by the driver's precision guard.

The search direction ``p`` is dense from iteration 0 (it starts at ``r0 =
b``), so an attached adaptive policy will route CG through plain SpMV —
which is itself the point: the policy must not pay SpMSpV overheads on
workloads with no frontier structure.
"""

from __future__ import annotations

import numpy as np

from repro_torch.solvers.adaptive import AdaptiveSpmvPolicy
from repro_torch.solvers.iterate import IterativeSolver, SolveResult


def cg(
    session,
    dense: np.ndarray,
    b: np.ndarray,
    *,
    tol: float = 1e-8,
    max_iters: int = 200,
    policy: AdaptiveSpmvPolicy | None = None,
    x0: np.ndarray | None = None,
    objective: str = "latency",
) -> SolveResult:
    """Solve ``A x = b`` (A symmetric positive-definite) by CG."""
    A = np.asarray(dense, dtype=np.float32)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = b.size
    b_norm = float(np.linalg.norm(b)) or 1.0
    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64)
    driver = IterativeSolver(
        session,
        A,
        name="cg",
        objective=objective,
        tol=tol,
        max_iters=max_iters,
        policy=policy,
    )

    # state = (x, r, p, rr): solution, residual, direction, r·r
    if x0 is None:
        r = b.copy()
    else:
        driver.setup()
        r = b - driver.matvec(x).astype(np.float64)
    state0 = (x, r, r.copy(), float(r @ r))

    def step(matvec, state):
        x, r, p, rr = state
        Ap = matvec(p).astype(np.float64)
        pAp = float(p @ Ap)
        if pAp <= 0:  # matrix not SPD on this direction; stop descending
            return (x, r, p, rr), float(np.linalg.norm(r)) / b_norm
        alpha = rr / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        rr_next = float(r @ r)
        p = r + (rr_next / rr) * p
        return (x, r, p, rr_next), float(np.sqrt(rr_next)) / b_norm

    return driver.solve(
        state0,
        step,
        value=lambda s: s[0],
        extras=lambda s: {"b_norm": b_norm},
    )
