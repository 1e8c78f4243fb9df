"""Per-iteration SpMV↔SpMSpV execution policy.

An iterative solve's input vector starts sparse (a seed vertex, a push
frontier) and densifies toward stationary. SpMSpV work scales with the
frontier's column nonzeros; dense SpMV always touches nnz(A); somewhere in
between lies a crossover. Li et al. (arXiv:2006.16767) switch on input
density online — this module does the same with two layers:

* a **threshold rule**: serve SpMSpV while ``frontier nnz / n_cols`` is
  below ``threshold`` (default 10%), SpMV after — the zero-state prior;
* an optional **phase bandit**: with an ``AdaptiveFormatSelector``
  attached, iterations are binned into density *phases*
  (``telemetry.adaptive.phase_arm_bucket``) and the two paths become UCB
  arms inside each phase cell, seeded by the threshold rule's pick as
  incumbent. Measured per-iteration wall times then learn the real
  crossover per matrix-family bucket instead of trusting the 10%.

The two arm names are execution *paths*, not sparse formats — they never
enter the format registry, and the bandit cells they occupy are keyed by
phase so they cannot collide with the format-selection cells for the same
bucket.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from repro_torch.obs.metrics import get_metrics
from repro_torch.telemetry.adaptive import phase_arm_bucket
from repro_torch.utils.logging import get_logger

log = get_logger("solvers.adaptive")

SPMV = "spmv"
SPMSPV = "spmspv"
ARMS = (SPMV, SPMSPV)

# density-phase bin edges: phase i covers [edges[i-1], edges[i])
DEFAULT_PHASE_EDGES = (0.02, 0.05, 0.10, 0.25, 0.50)
DEFAULT_THRESHOLD = 0.10

_M_SPMV = get_metrics().counter("solver_policy_spmv_total")
_M_SPMSPV = get_metrics().counter("solver_policy_spmspv_total")


@dataclass(frozen=True)
class PolicyDecision:
    """One iteration's routing decision, kept for tests and benchmarks."""

    kind: str  # "spmv" | "spmspv"
    density: float
    phase: int
    exploratory: bool = False


@dataclass
class AdaptiveSpmvPolicy:
    """Density-threshold SpMV↔SpMSpV switch with an optional phase bandit.

    Parameters
    ----------
    threshold:
        Frontier density below which the prior picks SpMSpV.
    selector:
        Optional ``telemetry.AdaptiveFormatSelector``; when present, each
        density phase is a bandit cell whose incumbent is the threshold
        rule's pick and whose measurements may overturn it.
    bucket / objective:
        The matrix-family cell identity the phase buckets scope into —
        pass the session plan's ``bucket``/``objective`` so solver cells
        live alongside (not inside) the format-selection cells.
    """

    threshold: float = DEFAULT_THRESHOLD
    phase_edges: tuple[float, ...] = DEFAULT_PHASE_EDGES
    selector: object | None = None  # telemetry.AdaptiveFormatSelector
    bucket: str = "solver"
    objective: str = "latency"
    decisions: list[PolicyDecision] = field(default_factory=list)

    @property
    def n_phases(self) -> int:
        return len(self.phase_edges) + 1

    def phase_of(self, density: float) -> int:
        return bisect.bisect_right(self.phase_edges, float(density))

    def _cell(self, phase: int) -> tuple[str, str]:
        return (
            phase_arm_bucket(self.bucket, phase, self.n_phases),
            self.objective,
        )

    def prior_kind(self, density: float) -> str:
        return SPMSPV if density < self.threshold else SPMV

    def choose(self, density: float) -> PolicyDecision:
        """Route one iteration; records and returns the decision."""
        phase = self.phase_of(density)
        incumbent = self.prior_kind(density)
        kind, exploratory = incumbent, False
        if self.selector is not None:
            cell_bucket, objective = self._cell(phase)
            kind, exploratory = self.selector.choose(
                cell_bucket, objective, incumbent, ARMS
            )
        decision = PolicyDecision(kind, float(density), phase, exploratory)
        self.decisions.append(decision)
        (_M_SPMSPV if kind == SPMSPV else _M_SPMV).inc()
        return decision

    def update(self, decision: PolicyDecision, measured_s: float) -> None:
        """Feed the measured iteration time back into the phase cell."""
        if self.selector is None:
            return
        cell_bucket, objective = self._cell(decision.phase)
        self.selector.update(cell_bucket, objective, decision.kind, measured_s)
        challenger = self.selector.review(cell_bucket, objective)
        if challenger is not None:
            # no cache to drop for a path switch: promotion IS the whole fix
            self.selector.promote(cell_bucket, objective, challenger)
            log.info(
                "solver phase %d crossover: %s -> %s (bucket=%s)",
                decision.phase,
                decision.kind,
                challenger,
                self.bucket,
            )

    def kinds(self) -> list[str]:
        return [d.kind for d in self.decisions]
