"""The Auto-SpMV optimizer: compile-time + run-time modes (paper §5, Fig. 5).

Compile-time mode (format fixed to CSR, §5.2):
  1. compute the sparsity features;
  2. predict the optimal kernel schedule (the compile-time parameters);
  3. convert to CSR and bind the CUDA kernel with that schedule.

Run-time mode (§5.3):
  1. compute the sparsity features;
  2. predict the optimal sparse format for the target objective;
  3. estimate the optimization overhead (feature extraction + conversion +
     2 model inferences);
  4. convert only if the predicted gain over the remaining iterations
     exceeds the predicted overhead.

The feature->decision stage is factored out as ``plan_compile_time`` /
``plan_run_time`` so the session layer (core/session.py) can cache plans by
feature bucket and re-apply them without re-running the predictors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.features import SparsityFeatures, extract_features
from repro_torch.core.overhead import OverheadPredictor
from repro_torch.core.predictor import AutoSpmvPredictor
from repro_torch.core.tuning_space import TuningConfig
from repro_torch.kernels.common import DEFAULT_SCHEDULE, KernelSchedule
from repro_torch.kernels.ops import PreparedSpmv, compile_spmv
from repro_torch.sparse.registry import default_format
from repro_torch.utils.logging import get_logger

log = get_logger("core.autotuner")

PREDICTED_OBJECTIVES = ("latency", "energy", "power", "efficiency")


@dataclass(frozen=True)
class CompileTimePlan:
    """The pure decision of compile-time mode: schedule + objective estimates.

    Matrix-independent given the sparsity features — this is what the
    session's ``TuningCache`` persists per feature bucket.
    """

    schedule: KernelSchedule
    predicted: dict[str, float]  # estimated objective values


@dataclass(frozen=True)
class RunTimePlan:
    """The pure decision of run-time mode, before the conversion gate."""

    best_format: str
    gain_per_iter: float  # objective units per kernel invocation
    latency_gain_per_iter: float  # seconds per invocation (the gating unit)
    overhead_s: float  # predicted f + c + o + p
    convert_overhead_s: float = 0.0  # the c term alone (re-charged by the
    # session when the prepared kernel is not actually memoized)


def should_convert(
    plan: RunTimePlan,
    n_iterations: int,
    current_format: str,
    overhead_s: float | None = None,
) -> bool:
    """Paper §5.3 conversion gate. ``overhead_s`` overrides the plan's
    predicted overhead — the session passes 0.0 on a cache hit because the
    f + c + o + p cost was already paid when the plan was first computed."""
    oh = plan.overhead_s if overhead_s is None else overhead_s
    return (
        plan.best_format != current_format
        and plan.gain_per_iter > 0
        and plan.latency_gain_per_iter * n_iterations > oh
    )


@dataclass(frozen=True)
class CompileTimeResult:
    features: SparsityFeatures
    schedule: KernelSchedule
    kernel: PreparedSpmv  # CSR kernel specialized with the predicted schedule
    predicted: dict[str, float]  # estimated objective values


@dataclass(frozen=True)
class RunTimeResult:
    features: SparsityFeatures
    best_format: str
    convert: bool  # decision after the overhead check
    predicted_gain_per_iter: float  # objective units per kernel invocation
    predicted_overhead: float  # seconds (f + c + o + p)
    kernel: PreparedSpmv | None  # converted kernel when convert=True


@dataclass
class AutoSpMV:
    predictor: AutoSpmvPredictor
    overhead: OverheadPredictor | None = None
    device: str | torch.device | None = None  # None = "cuda" (raises if absent)
    dataset: object | None = None  # the §5.4 TuningDataset the predictor was
    # fit on, when its constructor kept it — telemetry refits merge its labels so
    # a handful of fleet measurements never erase offline coverage
    cost_model: object | None = None  # the model that labelled that dataset;
    # partitioned planning scores with it (None: the reference-equal CostModel)

    # ------------------------------------------------------------- planning
    def plan_compile_time(
        self, feats: SparsityFeatures, objective: str = "latency"
    ) -> CompileTimePlan:
        schedule = self.predictor.predict_schedule(feats, objective)
        predicted = {
            obj: self.predictor.estimate_objective(
                feats, TuningConfig(default_format(), schedule), obj
            )
            for obj in PREDICTED_OBJECTIVES
        }
        return CompileTimePlan(schedule, predicted)

    def plan_run_time(
        self,
        feats: SparsityFeatures,
        objective: str = "latency",
        *,
        current_format: str | None = None,
        schedule: KernelSchedule = DEFAULT_SCHEDULE,
    ) -> RunTimePlan:
        current_format = current_format or default_format()
        best_fmt = self.predictor.predict_format(feats, objective)
        cur = self.predictor.estimate_objective(
            feats, TuningConfig(current_format, schedule), objective
        )
        new = self.predictor.estimate_objective(
            feats, TuningConfig(best_fmt, schedule), objective
        )
        # gain per kernel invocation, in the objective's native unit
        gain = (cur - new) if objective != "efficiency" else (new - cur)
        if self.overhead is not None:
            oh = self.overhead.total_overhead(feats, best_fmt)
            c_term = self.overhead.predict_c(feats, best_fmt)
        else:
            oh = c_term = 0.0
        # the decision rule compares time-like quantities; for non-latency
        # objectives the paper still gates on wall-clock overhead vs the
        # latency gain of the chosen config (§5.3) — reproduce that:
        lat_cur = self.predictor.estimate_objective(
            feats, TuningConfig(current_format, schedule), "latency"
        )
        lat_new = self.predictor.estimate_objective(
            feats, TuningConfig(best_fmt, schedule), "latency"
        )
        return RunTimePlan(best_fmt, gain, lat_cur - lat_new, oh, c_term)

    def plan_partitioned(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        block_counts: tuple[int, ...] | None = None,
        cost_model=None,
    ):
        """Partitioned run-time mode: split the matrix into nnz-balanced row
        blocks, run the format/schedule predictors per block, and search
        block counts {1, 2, 4, 8} — the monolithic plan stays the baseline
        and wins ties, so homogeneous matrices keep one block. Returns a
        ``repro_torch.partition.plan.CompositePlan``.

        Unlike ``plan_compile_time``/``plan_run_time`` this takes the dense
        matrix, not just features: block boundaries and per-block stats need
        the actual row histogram. The import is lazy — ``repro_torch.partition``
        sits above ``repro_torch.core`` in the layering. ``cost_model``
        (``None``: the tuner's own, ``self.cost_model``) scores the plans.
        """
        from repro_torch.partition.partitioner import SUPPORTED_BLOCK_COUNTS
        from repro_torch.partition.plan import plan_partitioned

        counts = (
            tuple(block_counts) if block_counts is not None else SUPPORTED_BLOCK_COUNTS
        )
        return plan_partitioned(
            self.predictor, dense, objective, block_counts=counts,
            cost_model=self.cost_model if cost_model is None else cost_model,
        )

    # ------------------------------------------------------------ compile time
    def compile_time_optimize(
        self, dense: np.ndarray, objective: str = "latency"
    ) -> CompileTimeResult:
        feats = extract_features(dense)
        plan = self.plan_compile_time(feats, objective)
        kernel = compile_spmv(
            dense, default_format(), plan.schedule, device=self.device
        )
        log.info("compile-time: %s -> %s", objective, plan.schedule)
        return CompileTimeResult(feats, plan.schedule, kernel, plan.predicted)

    # ---------------------------------------------------------------- run time
    def run_time_optimize(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        n_iterations: int = 1000,
        current_format: str | None = None,
        schedule: KernelSchedule = DEFAULT_SCHEDULE,
    ) -> RunTimeResult:
        current_format = current_format or default_format()
        feats = extract_features(dense)
        plan = self.plan_run_time(
            feats, objective, current_format=current_format, schedule=schedule
        )
        convert = should_convert(plan, n_iterations, current_format)
        kernel = (
            compile_spmv(dense, plan.best_format, schedule, device=self.device)
            if convert
            else None
        )
        log.info(
            "run-time: obj=%s fmt %s->%s gain/iter=%.3g overhead=%.3gs convert=%s",
            objective,
            current_format,
            plan.best_format,
            plan.gain_per_iter,
            plan.overhead_s,
            convert,
        )
        return RunTimeResult(
            feats,
            plan.best_format,
            convert,
            plan.gain_per_iter,
            plan.overhead_s,
            kernel,
        )
