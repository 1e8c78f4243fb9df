"""Heterogeneous composite planning: the run-time mode, per row block.

Auto-SpMV's run-time mode (paper §5.3) picks ONE format for the whole
matrix. A partitioned plan runs that mode once per row block: each block's
own Table-2 features go through the format classifier and the schedule
classifiers, every registered ``FormatSpec`` is a candidate, and the
analytical cost model scores the result on the block's *exact* storage
statistics. The block-count search {1, 2, 4, 8} keeps the monolithic plan
(one block) in the candidate set, so partitioning must pay for its extra
grid launches and per-block X traffic before it wins — a homogeneous matrix
falls back to the monolithic plan by construction.

Scoring uses the same ``CostModel`` that labelled the §5.4 dataset (by
default on the ``H100_SXM`` profile), so "modeled objective" means one
thing everywhere: per-block footprints are
evaluated on per-block ``MatrixStats`` and combined exactly (latency and
energy add across sequential block launches; power and efficiency are
re-derived from the sums, not averaged).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.features import row_nnz_counts
from repro_torch.core.objectives import MINIMIZE, CostModel, MatrixStats, ObjectiveValues
from repro_torch.kernels.common import KernelSchedule
from repro_torch.partition.partitioner import (
    SUPPORTED_BLOCK_COUNTS,
    RowBlock,
    RowPartition,
    partition_rows,
)
from repro_torch.sparse.registry import format_names
from repro_torch.utils.logging import get_logger

log = get_logger("partition.plan")

# the classifier's per-block pick survives unless another format's modeled
# value is better by more than this relative margin (the predictor routes;
# the cost model vetoes only clear mistakes)
PREDICTOR_TOLERANCE = 0.10
# a partitioned plan must beat the monolithic one by this relative margin
# before it replaces it — near-ties keep the simpler single-kernel plan
MIN_PARTITION_GAIN = 0.02


@dataclass(frozen=True)
class BlockPlan:
    """One block's routed decision: format + schedule + modeled objectives."""

    block: RowBlock
    fmt: str
    schedule: KernelSchedule
    modeled: ObjectiveValues
    predicted_fmt: str  # the classifier's raw pick (before the cost-model veto)

    def as_dict(self) -> dict:
        return {
            "row_start": self.block.row_start,
            "row_end": self.block.row_end,
            "nnz": self.block.nnz,
            "fmt": self.fmt,
            "schedule": self.schedule.as_dict(),
            "latency": self.modeled.latency,
            "predicted_fmt": self.predicted_fmt,
        }


@dataclass(frozen=True)
class CompositePlan:
    """A full partitioned decision for one matrix and objective."""

    objective: str
    partition: RowPartition
    blocks: tuple[BlockPlan, ...]
    modeled: ObjectiveValues  # combined modeled objectives of this plan
    monolithic: ObjectiveValues  # best single-format one-block baseline
    monolithic_fmt: str
    monolithic_schedule: KernelSchedule | None = None  # schedule the
    # baseline was scored at (executable comparisons must use this, not a
    # block's schedule)
    searched: tuple[int, ...] = SUPPORTED_BLOCK_COUNTS

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def partitioned(self) -> bool:
        return self.n_blocks > 1

    @property
    def formats(self) -> tuple[str, ...]:
        return tuple(b.fmt for b in self.blocks)

    def gain(self, objective: str | None = None) -> float:
        """Relative modeled improvement over the monolithic baseline
        (positive = the composite plan wins)."""
        obj = objective or self.objective
        base, ours = self.monolithic.get(obj), self.modeled.get(obj)
        if not np.isfinite(base) or base == 0:
            return 0.0
        rel = (base - ours) / abs(base)
        return rel if MINIMIZE[obj] else -rel


def combine(values: list[ObjectiveValues], useful_flops: float) -> ObjectiveValues:
    """Exact combination across sequential block launches on one device:
    latency and energy add; power and efficiency are re-derived from the
    sums (averaging per-block power would weight tiny blocks equally)."""
    if any(not v.feasible for v in values):
        from repro_torch.core.objectives import INFEASIBLE

        return INFEASIBLE
    latency = sum(v.latency for v in values)
    energy = sum(v.energy for v in values)
    power = energy / latency if latency > 0 else 0.0
    mflops = useful_flops / latency / 1e6 if latency > 0 else 0.0
    efficiency = mflops / power if power > 0 else 0.0
    return ObjectiveValues(latency, energy, power, efficiency)


def _cost(values: ObjectiveValues, objective: str) -> float:
    """Sign-normalized score: lower is always better."""
    v = values.get(objective)
    return v if MINIMIZE[objective] else -v


def _schedule_candidates(predicted: KernelSchedule) -> tuple[KernelSchedule, ...]:
    """The per-block schedule search: the classifier's pick plus the default.

    A schedule predicted from whole-matrix training labels can be hostile to
    an entire format family on a small block (nnz_tile=1024 forces every
    ELL-family width to >= 1024), which would make the format comparison
    meaningless. Two candidates keep the search O(formats x 2) while letting
    each block escape a schedule that was tuned for a different population.
    """
    from repro_torch.kernels.common import DEFAULT_SCHEDULE

    return (predicted,) if predicted == DEFAULT_SCHEDULE else (
        predicted,
        DEFAULT_SCHEDULE,
    )


def sweep_formats(
    stats: MatrixStats,
    schedules: tuple[KernelSchedule, ...],
    objective: str,
    cost_model: CostModel,
) -> dict[str, tuple[KernelSchedule, ObjectiveValues]]:
    """Best (schedule, modeled objectives) per registered format."""
    out: dict[str, tuple[KernelSchedule, ObjectiveValues]] = {}
    for fmt in format_names():
        best = None
        for sched in schedules:
            v = cost_model.evaluate(stats, fmt, sched)
            if best is None or (
                v.feasible and _cost(v, objective) < _cost(best[1], objective)
            ):
                best = (sched, v)
        out[fmt] = best
    return out


def route_block(
    predictor,
    block: RowBlock,
    stats: MatrixStats,
    objective: str,
    cost_model: CostModel,
) -> BlockPlan:
    """Run the run-time mode for ONE block: classifier-predicted format and
    schedule, cost-model-scored on the block's exact stats over the small
    per-block schedule search, with a registry sweep as the veto (an
    infeasible or clearly-losing pick is replaced by the best registered
    format at its best candidate schedule)."""
    feats = block.features
    fmt_pred = predictor.predict_format(feats, objective)
    sched_pred = predictor.predict_schedule(feats, objective)
    scored = sweep_formats(
        stats, _schedule_candidates(sched_pred), objective, cost_model
    )
    feasible = {f: sv for f, sv in scored.items() if sv[1].feasible}
    if not feasible:
        # nothing fits (degenerate schedule on a degenerate block): keep the
        # classifier's pick; the executor will surface InfeasibleConfig
        return BlockPlan(block, fmt_pred, sched_pred, scored[fmt_pred][1], fmt_pred)
    best_fmt = min(feasible, key=lambda f: _cost(feasible[f][1], objective))
    chosen = fmt_pred
    if fmt_pred not in feasible:
        chosen = best_fmt
    else:
        cp = _cost(feasible[fmt_pred][1], objective)
        cb = _cost(feasible[best_fmt][1], objective)
        if cp > cb + PREDICTOR_TOLERANCE * abs(cb):
            chosen = best_fmt
    schedule, modeled = scored[chosen]
    return BlockPlan(block, chosen, schedule, modeled, fmt_pred)


def plan_for_partition(
    predictor,
    dense: np.ndarray,
    part: RowPartition,
    objective: str,
    *,
    cost_model: CostModel | None = None,
) -> tuple[tuple[BlockPlan, ...], ObjectiveValues]:
    """Route every block of one partition; returns plans + combined model."""
    cm = cost_model or CostModel()
    dense = np.asarray(dense)
    plans = []
    for block in part.blocks:
        stats = MatrixStats(dense[block.row_start : block.row_end])
        plans.append(route_block(predictor, block, stats, objective, cm))
    useful = 2.0 * part.nnz
    return tuple(plans), combine([p.modeled for p in plans], useful)


def plan_partitioned(
    predictor,
    dense: np.ndarray,
    objective: str = "latency",
    *,
    block_counts: tuple[int, ...] = SUPPORTED_BLOCK_COUNTS,
    cost_model: CostModel | None = None,
    min_gain: float = MIN_PARTITION_GAIN,
) -> CompositePlan:
    """Search block counts and return the winning composite plan.

    The monolithic baseline (the best single registered format at the full
    matrix's predicted schedule) always competes; a partitioned candidate
    replaces it only when its combined modeled objective wins by at least
    ``min_gain``, so homogeneous matrices keep block count 1.

    With a ``CalibratedCostModel`` the comparison also reflects the measured
    per-launch fixed cost: ``combine`` sums per-block latencies, so a k-block
    candidate is charged k calibrated launch overheads against the
    monolithic plan's one — exactly the term whose absence made the
    uncalibrated planner over-partition.
    """
    cm = cost_model or CostModel()
    dense = np.asarray(dense)
    if 1 not in block_counts:
        block_counts = (1,) + tuple(block_counts)
    block_counts = tuple(sorted(set(block_counts)))

    candidates: dict[int, tuple[RowPartition, tuple[BlockPlan, ...], ObjectiveValues]] = {}
    counts = row_nnz_counts(dense)
    for k in block_counts:
        part = partition_rows(dense, k, row_counts=counts)
        if part.n_blocks in candidates:  # clamped duplicates (k > n_rows)
            continue
        plans, modeled = plan_for_partition(
            predictor, dense, part, objective, cost_model=cm
        )
        candidates[part.n_blocks] = (part, plans, modeled)

    _, mono_plans, _ = candidates[min(candidates)]
    # best single-format baseline: the full matrix, one block, every
    # registered format over the same schedule candidates the blocks get
    # (the predictor's full-matrix pick + the default) — partitioning must
    # beat the strongest monolithic plan, not a handicapped one
    full_stats = MatrixStats(dense)
    sched_full = predictor.predict_schedule(mono_plans[0].block.features, objective)
    mono_scores = sweep_formats(
        full_stats, _schedule_candidates(sched_full), objective, cm
    )
    mono_feasible = {
        f: sv for f, sv in mono_scores.items() if sv[1].feasible
    } or mono_scores
    monolithic_fmt = min(
        mono_feasible, key=lambda f: _cost(mono_feasible[f][1], objective)
    )
    monolithic = mono_scores[monolithic_fmt][1]

    best_k, best_cost = min(candidates), _cost(monolithic, objective)
    for k, (_, _, modeled) in sorted(candidates.items()):
        if k == 1 or not modeled.feasible:
            continue
        cost = _cost(modeled, objective)
        beats = (
            cost < best_cost - min_gain * abs(best_cost)
            if np.isfinite(best_cost)
            else np.isfinite(cost)
        )
        if beats:
            best_k, best_cost = k, cost

    if best_k == min(candidates):
        # fall back to the monolithic plan, pinned to the baseline format
        part, plans, _ = candidates[best_k]
        mono_sched = mono_scores[monolithic_fmt][0]
        plans = tuple(
            BlockPlan(p.block, monolithic_fmt, mono_sched, monolithic, p.predicted_fmt)
            for p in plans
        )
        chosen = CompositePlan(
            objective, part, plans, monolithic, monolithic, monolithic_fmt,
            monolithic_schedule=mono_sched, searched=block_counts,
        )
    else:
        part, plans, modeled = candidates[best_k]
        chosen = CompositePlan(
            objective, part, plans, modeled, monolithic, monolithic_fmt,
            monolithic_schedule=mono_scores[monolithic_fmt][0],
            searched=block_counts,
        )
    log.info(
        "partitioned plan: obj=%s searched=%s -> k=%d formats=%s gain=%.1f%% "
        "(monolithic %s, %s cost model)",
        objective,
        block_counts,
        chosen.n_blocks,
        "+".join(chosen.formats),
        100.0 * chosen.gain(),
        monolithic_fmt,
        "calibrated" if getattr(cm, "corrections", None) else "analytical",
    )
    return chosen
