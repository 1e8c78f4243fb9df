"""Iterative solvers over the Auto-SpMV serving stack.

The paper's amortize-forever argument (§5.3) — pay compile-time tuning
once, reuse the kernel thousands of times — only materializes in iterative
workloads. This package is that workload class:

* ``iterate``  — the generic ``IterativeSolver`` driver: ONE
  ``serve_optimize`` plan per solve, then every ``y = A @ x`` runs through
  the cached prepared kernel on the session's device with per-iteration
  ``observe()`` feedback, ``solver.iterate`` spans, and convergence
  bookkeeping; solver state stays on the host in numpy;
* ``adaptive`` — the per-iteration SpMV↔SpMSpV policy (frontier density
  threshold, learnable per density phase via the telemetry UCB bandit);
* ``pagerank`` / ``cg`` / ``power`` — damped PageRank with dangling-node
  handling, conjugate gradient for SPD systems, and power iteration, each
  returning a structured ``SolveResult``.
"""

from repro_torch.solvers.adaptive import AdaptiveSpmvPolicy, PolicyDecision
from repro_torch.solvers.cg import cg
from repro_torch.solvers.iterate import IterativeSolver, SolveResult
from repro_torch.solvers.pagerank import pagerank
from repro_torch.solvers.power import power_iteration

__all__ = [
    "AdaptiveSpmvPolicy",
    "IterativeSolver",
    "PolicyDecision",
    "SolveResult",
    "cg",
    "pagerank",
    "power_iteration",
]
