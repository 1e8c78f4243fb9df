"""UCB bandit over the classifier's prior + model-drift cache invalidation.

The serving path alone trusts the format classifier forever: a mispredicted
plan is cached and served until the process dies. This module closes the
loop the way adaptive SpMV selection does online (Li et al.,
arXiv:2006.16767): the *cached plan is the incumbent arm*, alternate formats
receive a bounded exploration budget, and measured wall times decide.

Two signals can evict a stale plan:

* **arm regret** — a challenger format's measured mean beats the incumbent's
  EWMA by more than ``drift_threshold`` (relative), sustained for
  ``drift_window`` consecutive incumbent observations;
* **model drift** — the incumbent's measured wall time exceeds the model's
  own latency estimate by more than ``drift_threshold``, sustained the same
  way (the §5.3 overhead/gain arithmetic is wrong for this bucket).

On invalidation the selector *promotes* the measured-best format to
incumbent (measurements outrank the model) and the caller drops the
``TuningCache`` entries so the next request re-plans — against predictors
the feedback loop may meanwhile have refit.

All rewards are measured wall times, minimized regardless of the tuning
objective: energy/power are not observable host-side, but every objective's
plan still has to be *executed*, so latency is the one universally measured
signal (the recorder keeps the per-objective aggregation for the dataset
export).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.obs.metrics import get_metrics
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import RollingStats

log = get_logger("telemetry.adaptive")

# fleet-visible bandit economics: how many pulls left the incumbent, and how
# often measurement overturned the model's plan
_M_EXPLORE = get_metrics().counter("spmv_bandit_explore_total")
_M_EXPLOIT = get_metrics().counter("spmv_bandit_exploit_total")
_M_PROMOTIONS = get_metrics().counter("spmv_drift_promotions_total")

CellKey = tuple[str, str]  # (bucket, objective)


def block_arm_bucket(bucket: str, index: int, n_blocks: int) -> str:
    """Bandit cell key for one row block of a partitioned plan.

    Partitioned serving with a selector attached (``AutoSpmvSession``'s
    ``serve_partitioned``/``observe_partitioned``; in the port those
    branches wait for the recorder, ROADMAP A.4) scopes every bandit cell
    to a block, so each (block, format) pair is its own arm: block 2 of a
    heterogeneous matrix can drift to SELL while block 0 keeps BELL, and a
    sustained-drift eviction re-plans the composite without touching the
    monolithic cells for the same feature bucket. ``n_blocks`` is part of
    the key — a 4-way and an 8-way split of the same bucket measure
    different row populations and must not share statistics."""
    return f"{bucket}#blk{index}of{n_blocks}"


def phase_arm_bucket(bucket: str, phase: int, n_phases: int) -> str:
    """Bandit cell key for one frontier-density phase of an iterative solve.

    The SpMV↔SpMSpV policy (``repro_torch.solvers.adaptive``) bins each
    iteration by input-vector density and treats the two execution paths
    as arms *within that phase*: a webgraph family can learn that phase 0
    (frontier under 2% dense) belongs to SpMSpV while phase 5 (near-dense)
    belongs to SpMV, with the crossover point emerging from measurements
    instead of a hardcoded threshold. ``n_phases`` is part of the key for
    the same reason as ``block_arm_bucket``'s ``n_blocks``: re-binning the
    density axis changes what each phase measures."""
    return f"{bucket}#ph{phase}of{n_phases}"


@dataclass
class AdaptiveConfig:
    exploration_bonus: float = 0.5  # UCB width, in units of the best arm's mean
    exploration_fraction: float = 0.25  # max fraction of pulls spent off-incumbent
    prior_weight: int = 2  # pseudo-pulls crediting the model's estimate to the incumbent
    min_challenger_pulls: int = 2  # observations before a challenger can evict
    drift_window: int = 4  # consecutive drifted incumbent observations to invalidate
    drift_threshold: float = 0.25  # relative margin for both drift signals
    window: int = 64  # RollingStats window per arm
    ewma_alpha: float = 0.3


@dataclass
class ArmState:
    stats: RollingStats  # LOCALLY MEASURED samples only — neither priors nor
    # absorbed peer evidence ever contaminate it (exported fleet shards carry
    # exactly these pulls, so fleet-merged counts stay echo-free)
    pulls: int = 0  # real local observations
    prior_pulls: int = 0  # pseudo-pull credit from the model's estimate
    prior_value: float | None = None  # the estimate itself (UCB value until
    # the first real pull; model scale may differ from measured scale, so it
    # must never be averaged into the measured mean)
    disabled: bool = False  # conversion infeasible for this cell: never pick
    absorbed_pulls: int = 0  # peer-measured pulls installed by absorb()
    absorbed_value: float | None = None  # pull-weighted peer mean (measured
    # scale, same clock as stats — peers run the same serving path)

    @property
    def n_eff(self) -> int:
        return self.pulls + self.prior_pulls + self.absorbed_pulls

    @property
    def measured_pulls(self) -> int:
        """Local + absorbed peer observations (prior pseudo-pulls excluded)."""
        return self.pulls + self.absorbed_pulls

    def measured_mean(self) -> float | None:
        """Pull-weighted mean over local + absorbed measurements."""
        n, total = 0, 0.0
        if self.pulls:
            n += self.pulls
            total += self.stats.mean * self.pulls
        if self.absorbed_pulls and self.absorbed_value is not None:
            n += self.absorbed_pulls
            total += self.absorbed_value * self.absorbed_pulls
        return total / n if n else None

    def value(self) -> float | None:
        """Mean for UCB scoring: measured when available, else the prior."""
        measured = self.measured_mean()
        return measured if measured is not None else self.prior_value


@dataclass
class CellState:
    """Bandit state for one (bucket, objective) plan-cache cell."""

    incumbent: str
    arms: dict[str, ArmState] = field(default_factory=dict)
    total_pulls: int = 0
    exploration_pulls: int = 0
    drift_strikes: int = 0
    model_drift_strikes: int = 0  # measured > modeled subset of the strikes:
    # high while arm-regret strikes stay low means the cost-model *scale* is
    # off, not the plan — the signal that it is time to recalibrate
    # (``CalibratedCostModel`` puts predicted_s on the measured scale, which
    # collapses these without touching real plan regressions)
    promoted: bool = False  # incumbent came from measurement, not the model
    invalidations: int = 0


class AdaptiveFormatSelector:
    """Per-cell UCB1 with an incumbent prior and a sustained-drift evictor."""

    def __init__(self, config: AdaptiveConfig | None = None):
        self.config = config or AdaptiveConfig()
        self._cells: dict[CellKey, CellState] = {}

    # ------------------------------------------------------------- internals
    def _cell(
        self, bucket: str, objective: str, incumbent: str, prior_value: float | None
    ) -> CellState:
        key = (bucket, objective)
        cell = self._cells.get(key)
        if cell is None:
            cell = CellState(incumbent=incumbent)
            self._cells[key] = cell
            self._seed_prior(cell, incumbent, prior_value)
        elif not cell.promoted and incumbent != cell.incumbent:
            # the plan changed under us (cache invalidation + re-plan, or a
            # refit predictor): adopt it and credit its estimate
            cell.incumbent = incumbent
            cell.drift_strikes = 0
            self._seed_prior(cell, incumbent, prior_value)
        elif cell.promoted and incumbent == cell.incumbent:
            cell.promoted = False  # the model caught up with the measurements
        return cell

    def _seed_prior(self, cell: CellState, fmt: str, prior_value: float | None) -> None:
        arm = self._arm(cell, fmt)
        if prior_value is None or prior_value <= 0 or arm.prior_pulls:
            return
        arm.prior_value = float(prior_value)
        arm.prior_pulls = self.config.prior_weight

    def _arm(self, cell: CellState, fmt: str) -> ArmState:
        arm = cell.arms.get(fmt)
        if arm is None:
            arm = ArmState(RollingStats(self.config.window, self.config.ewma_alpha))
            cell.arms[fmt] = arm
        return arm

    @staticmethod
    def _best_measured(cell: CellState, min_pulls: int = 1) -> str | None:
        cands = [
            (arm.measured_mean(), fmt)
            for fmt, arm in cell.arms.items()
            if arm.measured_pulls >= min_pulls
            and not arm.disabled
            and arm.measured_mean() is not None
        ]
        return min(cands)[1] if cands else None

    def disable(
        self, bucket: str, objective: str, fmt: str, *, fallback: str | None = None
    ) -> None:
        """Mark a format unservable for this cell (conversion infeasible):
        ``choose`` will never pick it again, so a failed exploration is paid
        once per cell, not once per request. If the *incumbent* itself is
        disabled (the cached plan was infeasible), the measured-best arm —
        or ``fallback``, the format the caller actually served (defaulting
        to the registry's default format) — takes over, so a budget-closed
        ``choose`` never returns an unservable arm."""
        if fallback is None:
            from repro_torch.sparse.registry import default_format

            fallback = default_format()
        cell = self._cells.get((bucket, objective))
        if cell is None:
            return
        self._arm(cell, fmt).disabled = True
        if fmt == cell.incumbent:
            cell.incumbent = self._best_measured(cell) or fallback
            cell.promoted = True
            cell.drift_strikes = 0

    # ----------------------------------------------------------------- choose
    def choose(
        self,
        bucket: str,
        objective: str,
        incumbent: str,
        candidates: tuple[str, ...],
        *,
        prior_value: float | None = None,
    ) -> tuple[str, bool]:
        """Pick the format to serve this request; returns (fmt, exploratory).

        ``incumbent`` is the cached plan's format, ``prior_value`` the
        model's latency estimate for it (seeds the incumbent arm so the
        classifier's opinion is the starting point, not ignored).
        """
        cfg = self.config
        cell = self._cell(bucket, objective, incumbent, prior_value)
        # bounded exploration: off-incumbent pulls may not exceed the budget
        budget_open = cell.exploration_pulls < max(
            cfg.exploration_fraction * (cell.total_pulls + 1), 1.0
        )
        if not budget_open and not self._arm(cell, cell.incumbent).disabled:
            _M_EXPLOIT.inc()
            return cell.incumbent, False
        best_ref = None
        for fmt in candidates:
            v = self._arm(cell, fmt).value()
            if v is not None and (best_ref is None or v < best_ref):
                best_ref = v
        ref = best_ref if best_ref and best_ref > 0 else 1.0
        ln_n = math.log(cell.total_pulls + 1.0 + len(candidates))
        best_fmt, best_score = None, -math.inf
        for fmt in candidates:
            arm = self._arm(cell, fmt)
            if arm.disabled:
                continue
            v = arm.value()
            if v is None:
                # untried, prior-less arm: forced (budget-gated) pull —
                # unless the budget is closed and we are only here because
                # the incumbent is unservable
                score = math.inf if budget_open else -math.inf
            else:
                width = cfg.exploration_bonus * ref * math.sqrt(ln_n / arm.n_eff)
                score = -v + width
            if score > best_score:
                best_fmt, best_score = fmt, score
        if best_fmt is None:  # everything disabled: serve the incumbent as-is
            best_fmt = cell.incumbent
        exploratory = best_fmt != cell.incumbent
        (_M_EXPLORE if exploratory else _M_EXPLOIT).inc()
        return best_fmt, exploratory

    # ----------------------------------------------------------------- update
    def update(
        self,
        bucket: str,
        objective: str,
        fmt: str,
        measured_s: float,
        *,
        predicted_s: float | None = None,
    ) -> None:
        """Fold one measured outcome into the bandit state."""
        cell = self._cells.get((bucket, objective))
        if cell is None:  # observation without a prior choose() — adopt it
            cell = self._cell(bucket, objective, fmt, predicted_s)
        arm = self._arm(cell, fmt)
        arm.stats.add(float(measured_s))
        arm.pulls += 1
        cell.total_pulls += 1
        if fmt != cell.incumbent:
            cell.exploration_pulls += 1
            return
        # drift detection runs on incumbent observations only
        cfg = self.config
        model_drift = (
            predicted_s is not None
            and predicted_s > 0
            and measured_s > predicted_s * (1.0 + cfg.drift_threshold)
        )
        cell.model_drift_strikes = cell.model_drift_strikes + 1 if model_drift else 0
        drifted = model_drift
        inc_ewma = arm.stats.ewma if arm.stats.ewma is not None else arm.stats.mean
        for other_fmt, other in cell.arms.items():
            if other_fmt == fmt or other.pulls < cfg.min_challenger_pulls:
                continue
            drifted |= other.stats.mean * (1.0 + cfg.drift_threshold) < inc_ewma
        cell.drift_strikes = cell.drift_strikes + 1 if drifted else 0

    # ----------------------------------------------------------------- review
    def review(self, bucket: str, objective: str) -> str | None:
        """Return the measured-best challenger if the incumbent should be
        evicted (sustained drift), else None. Idempotent until ``promote``.

        Eviction requires the challenger to beat the incumbent's measured
        EWMA by the full ``drift_threshold`` margin: model-drift strikes
        alone (e.g. a wrong cost-model scale, which makes every measurement
        exceed its estimate) or a noise-level difference between near-equal
        formats must never thrash the cache."""
        cell = self._cells.get((bucket, objective))
        if cell is None or cell.drift_strikes < self.config.drift_window:
            return None
        challenger = self._best_measured(cell, self.config.min_challenger_pulls)
        inc = cell.arms.get(cell.incumbent)
        inc_val = None
        if inc is not None and inc.pulls:
            inc_val = inc.stats.ewma if inc.stats.ewma is not None else inc.stats.mean
        margin_beaten = (
            challenger is not None
            and challenger != cell.incumbent
            and inc_val is not None
            and cell.arms[challenger].measured_mean()
            * (1.0 + self.config.drift_threshold)
            < inc_val
        )
        if not margin_beaten:
            cell.drift_strikes = 0
            return None
        return challenger

    def promote(self, bucket: str, objective: str, fmt: str) -> None:
        """Install the measured-best format as incumbent after an eviction."""
        cell = self._cells.get((bucket, objective))
        if cell is None:
            return
        log.info(
            "promoting %s over %s for bucket=%s objective=%s after %d strikes",
            fmt,
            cell.incumbent,
            bucket,
            objective,
            cell.drift_strikes,
        )
        cell.incumbent = fmt
        cell.promoted = True
        cell.drift_strikes = 0
        cell.exploration_pulls = 0
        cell.invalidations += 1
        _M_PROMOTIONS.inc()

    # ------------------------------------------------------------- fleet sync
    def absorb(
        self, bucket: str, objective: str, fmt: str, *, pulls: int, value: float
    ) -> None:
        """Install peer-measured evidence for one arm (idempotent setter).

        ``pulls``/``value`` are the *cumulative* totals over the current
        peer shard set for this arm — ``FleetSync`` recomputes them from
        scratch each sync, so absorbing the same shards twice changes
        nothing and a vanished peer's evidence ages out with its shard.
        Peer evidence lands in ``absorbed_*``, never in the local ``stats``:
        exported shards carry only locally-measured pulls, which keeps
        fleet-merged pull counts equal to the per-instance sum (no echo
        amplification through sync round-trips)."""
        if pulls <= 0 or value is None or value <= 0:
            return
        key = (bucket, objective)
        cell = self._cells.get(key)
        if cell is None:
            # a bucket this instance has never served: adopt the peer's arm
            # as a provisional incumbent until a local plan claims the cell
            cell = CellState(incumbent=fmt)
            self._cells[key] = cell
        arm = self._arm(cell, fmt)
        arm.absorbed_pulls = int(pulls)
        arm.absorbed_value = float(value)

    def reconcile(self, bucket: str, objective: str) -> str | None:
        """Promote the measured-best arm (local + absorbed) over the
        incumbent when it wins by the drift margin — ``review``'s fleet
        counterpart, minus the strike counting: peer evidence arrives in
        batches of pulls, not one incumbent observation at a time, so a
        single sync can carry a whole drift window's worth of proof."""
        cell = self._cells.get((bucket, objective))
        if cell is None:
            return None
        best = self._best_measured(cell, self.config.min_challenger_pulls)
        if best is None or best == cell.incumbent:
            return None
        inc = cell.arms.get(cell.incumbent)
        inc_val = inc.measured_mean() if inc is not None else None
        if inc_val is None and inc is not None:
            inc_val = inc.prior_value
        best_val = cell.arms[best].measured_mean()
        if inc_val is None or best_val * (1.0 + self.config.drift_threshold) < inc_val:
            self.promote(bucket, objective, best)
            return best
        return None

    # ---------------------------------------------------------------- queries
    def cells(self) -> dict[CellKey, CellState]:
        """Live cell map (posterior export reads arms/incumbents off it)."""
        return dict(self._cells)

    def incumbent(self, bucket: str, objective: str) -> str | None:
        cell = self._cells.get((bucket, objective))
        return cell.incumbent if cell is not None else None

    def warm_start(self, recorder) -> int:
        """Seed arm statistics from a replayed ``TelemetryRecorder`` so a
        restarted server does not re-pay exploration it already logged."""
        seeded = 0
        for (bucket, objective, fmt), agg in recorder.arms().items():
            cell = self._cells.get((bucket, objective))
            if cell is None:
                cell = CellState(incumbent=fmt)
                self._cells[(bucket, objective)] = cell
            arm = self._arm(cell, fmt)
            if arm.pulls:
                continue
            arm.stats.add(agg.stats.mean)
            arm.pulls += 1
            cell.total_pulls += 1
            seeded += 1
        return seeded

    def summary(self) -> dict:
        return {
            "cells": len(self._cells),
            "pulls": sum(c.total_pulls for c in self._cells.values()),
            "exploration_pulls": sum(
                c.exploration_pulls for c in self._cells.values()
            ),
            "promotions": sum(c.invalidations for c in self._cells.values()),
            "promoted_cells": sum(1 for c in self._cells.values() if c.promoted),
            "model_drift_strikes": sum(
                c.model_drift_strikes for c in self._cells.values()
            ),
            "absorbed_pulls": sum(
                a.absorbed_pulls
                for c in self._cells.values()
                for a in c.arms.values()
            ),
        }
