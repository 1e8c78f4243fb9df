"""Autotuning session: amortized, batched, restart-surviving Auto-SpMV.

``AutoSpmvSession`` wraps the one-shot ``AutoSpMV`` optimizer with the three
things a serving system needs (ROADMAP north star: caching, batching, faster
hot path):

1. **Plan cache** — decisions are memoized in a feature-bucketed
   ``TuningCache`` (core/cache.py) with JSON save/load, so the predictor
   inferences run once per (bucket, objective) per fleet, not once per call.
2. **Kernel memo** — prepared kernels are memoized process-wide by
   matrix fingerprint (kernels/ops.py), so repeated matrices skip format
   conversion and kernel specialization entirely.
3. **Batched tuning** — ``optimize_many`` deduplicates a batch of matrices
   by content fingerprint, tunes each unique matrix once, and fans the
   shared results back out in input order.

Amortized overhead accounting (paper §5.3): the run-time-mode conversion
gate charges the full ``f + c + o + p`` overhead only on a plan-cache
*miss*. On a hit the decision terms (f, o, p) were already paid when the
bucket was first tuned; the conversion term ``c`` is charged only when the
prepared kernel is actually absent from the process-wide kernel memo (fresh
process after a JSON reload, LRU eviction, or a different matrix landing in
the same feature bucket) — the gate always sees the true marginal cost.

Telemetry hooks (repro_torch/telemetry): a session optionally carries a
``TelemetryRecorder`` and an ``AdaptiveFormatSelector``. ``serve_optimize``
consults the bandit for the format to serve (the cached plan is the
incumbent arm), ``observe`` feeds measured wall times back, and a sustained
drift verdict invalidates the stale cache entries so the next request
re-plans. Both collaborators are duck-typed — the session never imports the
telemetry package at module level, so ``repro_torch.core`` stays
import-cycle-free.

Partitioned plans (``partitioned_optimize``) are cached per feature bucket
under a ``part:max<k>`` mode and replayed onto each matrix's own row
boundaries; with ``fused=True`` the composite runs as one launch. A
``cost_model=`` given to the session scores those plans, else the model that
labelled the tuner's dataset.
With a selector, ``serve_partitioned`` gives every row block its own
bandit cell (``block_arm_bucket``) and ``observe_partitioned`` feeds each
(block, format) arm its own measured time. ``calibrate`` fits a
``CalibratedCostModel`` to the recorder's (predicted, measured) pairs, saves
it as ``<cache>.calibration.json`` beside the tuning cache, and a session
built over that cache path loads it again. ``compile_spmspv`` adds the
sparse-frontier twin of a plan's kernel for the iterative solvers, booked
like any other compile.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.autotuner import (
    AutoSpMV,
    CompileTimeResult,
    RunTimePlan,
    RunTimeResult,
    should_convert,
)
from repro_torch.core.cache import CacheEntry, TuningCache
from repro_torch.core.features import SparsityFeatures, extract_features
from repro_torch.kernels.common import DEFAULT_SCHEDULE, KernelSchedule
from repro_torch.kernels.ops import (
    compile_spmspv as _compile_spmspv_kernel,
    compile_spmv,
    kernel_memo_stats,
    kernel_memoized,
    matrix_fingerprint,
)
from repro_torch.obs.trace import span as _span
from repro_torch.sparse.registry import default_format, format_names
from repro_torch.utils.logging import get_logger

log = get_logger("core.session")


@dataclass
class SessionStats:
    """What the session actually paid for vs. what it reused."""

    requests: int = 0
    feature_extractions: int = 0  # actual Table-2 passes (f term)
    plans_computed: int = 0  # actual predictor inferences (o + p terms)
    kernel_compiles: int = 0  # actual prepare+bind passes (c term)
    cache_hits: int = 0
    cache_misses: int = 0
    overhead_paid_s: float = 0.0  # predicted overhead charged on misses
    overhead_saved_s: float = 0.0  # predicted overhead skipped on hits
    observations: int = 0  # measured executions fed back via observe()
    explorations: int = 0  # bandit pulls served off the incumbent plan
    invalidations: int = 0  # drift-triggered cache evictions

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "feature_extractions": self.feature_extractions,
            "plans_computed": self.plans_computed,
            "kernel_compiles": self.kernel_compiles,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "overhead_paid_s": self.overhead_paid_s,
            "overhead_saved_s": self.overhead_saved_s,
            "observations": self.observations,
            "explorations": self.explorations,
            "invalidations": self.invalidations,
        }


def _run_mode_key(current_format: str, schedule: KernelSchedule) -> str:
    """Run-time plans depend on the held format (gain is measured against
    it) and, through the objective estimates, on the comparison schedule."""
    if schedule == DEFAULT_SCHEDULE:
        return f"run:{current_format}"
    tag = "_".join(f"{k}={v}" for k, v in sorted(schedule.as_dict().items()))
    return f"run:{current_format}:{tag}"


def _part_mode_key(max_blocks: int) -> str:
    """Partitioned plans are keyed by their block-count budget: sessions
    running with different ``--max-blocks`` must not alias entries."""
    return f"part:max{max_blocks}"


def _calibration_path(cache_path: Path) -> Path:
    """Where a session persists its fitted cost-model corrections: a sibling
    of the tuning cache, so the two artifacts travel (and restart) together."""
    return cache_path.with_name(cache_path.stem + ".calibration.json")


@dataclass(frozen=True)
class PartitionedResult:
    """What ``partitioned_optimize`` returns: the composite plan actually
    applied to this matrix, its executor, and enough identity for
    ``observe_partitioned`` to feed every (block, format) arm."""

    fingerprint: str
    features: SparsityFeatures
    bucket: str
    objective: str
    plan: object  # repro_torch.partition.plan.CompositePlan
    kernel: object  # PartitionedSpmv or FusedPartitionedSpmv
    mode: str  # the cache mode key ("part:max<k>")
    cache_hit: bool = False
    served_formats: tuple[str, ...] = ()  # per block, after bandit swaps
    exploratory: tuple[bool, ...] = ()  # per block: served off the plan

    @property
    def n_blocks(self) -> int:
        return self.plan.n_blocks

    @property
    def formats(self) -> tuple[str, ...]:
        return self.served_formats or self.plan.formats


@dataclass(frozen=True)
class ServedPlan:
    """What ``serve_optimize`` hands the serving layer: the plan actually
    served this request, with enough identity for ``observe`` to attribute
    the measured outcome back to the right telemetry arm."""

    fingerprint: str
    features: SparsityFeatures
    bucket: str
    objective: str
    fmt: str  # format served (bandit may diverge from the cached plan)
    schedule: KernelSchedule
    kernel: object  # PreparedSpmv
    predicted: dict  # model objective estimates for the cached plan
    plan_id: str  # "bucket/objective/mode" string for the telemetry log
    exploratory: bool = False  # this pull was bandit exploration
    cache_hit: bool = False  # the schedule plan pre-existed this request
    predicted_s: float | None = None  # model latency estimate for the SERVED
    # format (drift detection compares measured against this, not against
    # the csr compile-plan estimate)


class AutoSpmvSession:
    """A long-lived tuning context sharing one cache across many matrices.

    Parameters
    ----------
    tuner:
        The wrapped ``AutoSpMV`` optimizer (predictors + overhead model).
    cache:
        An existing ``TuningCache`` to share; mutually exclusive with
        ``cache_path`` loading.
    cache_path:
        Optional JSON path. If the file exists the cache is warmed from it;
        ``save()`` writes back to the same path by default.
    telemetry:
        Optional ``repro_torch.telemetry.TelemetryRecorder`` (duck-typed);
        ``observe`` forwards measured outcomes to it.
    adaptive:
        Optional ``repro_torch.telemetry.AdaptiveFormatSelector`` (duck-typed);
        ``serve_optimize`` consults it and ``observe`` updates it, including
        drift-triggered cache invalidation.
    cost_model:
        Optional ``CostModel`` (e.g. on another ``HardwareProfile``) that
        ``partitioned_optimize`` scores plans with; ``None`` loads
        ``<cache>.calibration.json`` where one lies beside ``cache_path``,
        else leaves it to the tuner's own model (``AutoSpMV.cost_model``:
        ``CardCostModel`` for a tuner ``build_tuner`` built on a card).
    """

    def __init__(
        self,
        tuner: AutoSpMV,
        cache: TuningCache | None = None,
        cache_path: str | Path | None = None,
        *,
        telemetry=None,
        adaptive=None,
        cost_model=None,
    ):
        if cache is None:
            if cache_path is not None and Path(cache_path).exists():
                try:
                    cache = TuningCache.load(cache_path)
                except Exception as exc:  # corrupt/stale file: cold start
                    log.warning(
                        "ignoring unreadable tuning cache %s (%s); starting cold",
                        cache_path,
                        exc,
                    )
                    cache = TuningCache()
            else:
                cache = TuningCache()
        self.tuner = tuner
        self.cache = cache
        self.cache_path = Path(cache_path) if cache_path is not None else None
        if cost_model is None and self.cache_path is not None:
            cal_path = _calibration_path(self.cache_path)
            if cal_path.exists():
                try:
                    from repro_torch.core.objectives import CalibratedCostModel

                    cost_model = CalibratedCostModel.load(cal_path)
                    log.info(
                        "loaded cost-model calibration from %s (%d formats)",
                        cal_path,
                        len(cost_model.corrections),
                    )
                except Exception as exc:  # advisory artifact: cold-start fine
                    log.warning(
                        "ignoring unreadable calibration %s (%s)", cal_path, exc
                    )
        self.telemetry = telemetry
        self.adaptive = adaptive
        self.cost_model = cost_model
        self.stats = SessionStats()
        # fingerprint -> (features, bucket): dedups the f term. LRU-bounded
        # like the kernel memo — a server streaming distinct matrices must
        # not grow per-matrix state forever (entries are small, so the
        # bound is generous).
        self._feat_memo: OrderedDict[str, tuple[SparsityFeatures, str]] = OrderedDict()
        self._feat_memo_limit = 8192
        # (bucket, objective, fmt) -> regressor latency estimate: one cheap
        # inference per arm per fleet, dropped with the bucket on invalidate
        self._pred_memo: dict[tuple[str, str, str], float] = {}

    # ------------------------------------------------------------- internals
    def _analyze(
        self, dense: np.ndarray, fingerprint: str | None = None
    ) -> tuple[str, SparsityFeatures, str]:
        with _span("session.analyze") as sp:
            fp = fingerprint
            if fp is None:
                with _span("matrix.fingerprint"):
                    fp = matrix_fingerprint(dense)
            cached = self._feat_memo.get(fp)
            sp.set(memo_hit=cached is not None)
            if cached is not None:
                self._feat_memo.move_to_end(fp)
                return fp, cached[0], cached[1]
            with _span("features.extract"):
                feats = extract_features(dense)
        self.stats.feature_extractions += 1
        bucket = self.cache.bucket_of(feats)
        self._feat_memo[fp] = (feats, bucket)
        while len(self._feat_memo) > self._feat_memo_limit:
            self._feat_memo.popitem(last=False)
        return fp, feats, bucket

    def _compile(
        self, dense: np.ndarray, fp: str, fmt: str, schedule: KernelSchedule
    ):
        before = kernel_memo_stats()["compiles"]
        kernel = compile_spmv(
            dense, fmt, schedule, device=self.tuner.device, memo_key=fp
        )
        self.stats.kernel_compiles += kernel_memo_stats()["compiles"] - before
        return kernel

    def compile_spmspv(
        self, dense: np.ndarray, schedule: KernelSchedule = DEFAULT_SCHEDULE
    ):
        """Session-accounted SpMSpV compilation (sparse-frontier twin path).

        Shares the matrix fingerprint (and thus the process kernel memo)
        with the SpMV plans for the same matrix, puts the storage on the
        tuner's device, and books any real conversion into
        ``stats.kernel_compiles`` — so an iterative solver that lazily adds
        the SpMSpV path still shows up as exactly one extra compile in the
        amortization counters."""
        fp, _, _ = self._analyze(dense)
        before = kernel_memo_stats()["compiles"]
        prepared = _compile_spmspv_kernel(
            dense, schedule, device=self.tuner.device, memo_key=fp
        )
        self.stats.kernel_compiles += kernel_memo_stats()["compiles"] - before
        return prepared

    def plan_key(
        self,
        features: SparsityFeatures,
        objective: str,
        mode: str = "compile",
        *,
        current_format: str | None = None,
        schedule: KernelSchedule = DEFAULT_SCHEDULE,
    ) -> tuple[str, str, str]:
        """The cache key a request with these features resolves to.

        Callers (e.g. the SpMV server's hit reporting) should use this
        instead of re-deriving bucket/mode strings from cache internals."""
        current_format = current_format or default_format()
        m = mode if mode == "compile" else _run_mode_key(current_format, schedule)
        return (self.cache.bucket_of(features), objective, m)

    # ---------------------------------------------------------- compile time
    def compile_time_optimize(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        fingerprint: str | None = None,
    ) -> CompileTimeResult:
        self.stats.requests += 1
        with _span("session.optimize", mode="compile", objective=objective) as sp:
            fp, feats, bucket = self._analyze(dense, fingerprint)
            with _span("cache.lookup", bucket=bucket, mode="compile"):
                entry = self.cache.get(bucket, objective, "compile")
            hit = entry is not None
            if entry is None:
                with _span("plan.compute", bucket=bucket, mode="compile"):
                    plan = self.tuner.plan_compile_time(feats, objective)
                self.stats.plans_computed += 1
                self.stats.cache_misses += 1
                entry = self.cache.put(
                    CacheEntry(
                        bucket=bucket,
                        objective=objective,
                        mode="compile",
                        fmt=default_format(),
                        schedule=plan.schedule.as_dict(),
                        predicted=dict(plan.predicted),
                    )
                )
                log.info("compile-time miss: bucket=%s -> %s", bucket, plan.schedule)
            else:
                self.stats.cache_hits += 1
            sp.set(bucket=bucket, cache_hit=hit)
            schedule = entry.kernel_schedule()
            kernel = self._compile(dense, fp, default_format(), schedule)
        return CompileTimeResult(feats, schedule, kernel, dict(entry.predicted))

    # -------------------------------------------------------------- run time
    def run_time_optimize(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        n_iterations: int = 1000,
        current_format: str | None = None,
        schedule: KernelSchedule = DEFAULT_SCHEDULE,
        fingerprint: str | None = None,
    ) -> RunTimeResult:
        current_format = current_format or default_format()
        self.stats.requests += 1
        with _span("session.optimize", mode="run", objective=objective) as sp:
            fp, feats, bucket = self._analyze(dense, fingerprint)
            mode = _run_mode_key(current_format, schedule)
            with _span("cache.lookup", bucket=bucket, mode=mode):
                entry = self.cache.get(bucket, objective, mode)
            sp.set(bucket=bucket, cache_hit=entry is not None)
            if entry is None:
                with _span("plan.compute", bucket=bucket, mode=mode):
                    plan = self.tuner.plan_run_time(
                        feats,
                        objective,
                        current_format=current_format,
                        schedule=schedule,
                    )
                self.stats.plans_computed += 1
                self.stats.cache_misses += 1
                self.cache.put(
                    CacheEntry(
                        bucket=bucket,
                        objective=objective,
                        mode=mode,
                        fmt=plan.best_format,
                        schedule=schedule.as_dict(),
                        gain_per_iter=plan.gain_per_iter,
                        latency_gain_per_iter=plan.latency_gain_per_iter,
                        overhead_s=plan.overhead_s,
                        convert_overhead_s=plan.convert_overhead_s,
                    )
                )
                # first sight of this bucket: pay the decision terms, but
                # credit the conversion term if the kernel is already
                # memoized (e.g. a plan for another objective converted this
                # matrix earlier)
                overhead_eff = plan.overhead_s
                if kernel_memoized(
                    fp, plan.best_format, schedule, device=self.tuner.device
                ):
                    overhead_eff -= plan.convert_overhead_s
                self.stats.overhead_paid_s += overhead_eff
            else:
                self.stats.cache_hits += 1
                plan = RunTimePlan(
                    entry.fmt,
                    entry.gain_per_iter,
                    entry.latency_gain_per_iter,
                    entry.overhead_s,
                    entry.convert_overhead_s,
                )
                # §5.3 amortization: the decision terms (f, o, p) were paid
                # when the bucket was first tuned; conversion (c) only
                # re-applies if the prepared kernel is not actually memoized
                # in this process.
                if kernel_memoized(
                    fp, plan.best_format, schedule, device=self.tuner.device
                ):
                    overhead_eff = 0.0
                else:
                    overhead_eff = plan.convert_overhead_s
                self.stats.overhead_saved_s += plan.overhead_s - overhead_eff
            convert = should_convert(
                plan, n_iterations, current_format, overhead_s=overhead_eff
            )
            kernel = (
                self._compile(dense, fp, plan.best_format, schedule)
                if convert
                else None
            )
        log.info(
            "run-time(session): obj=%s bucket=%s fmt %s->%s overhead=%.3gs convert=%s",
            objective,
            bucket,
            current_format,
            plan.best_format,
            overhead_eff,
            convert,
        )
        return RunTimeResult(
            feats, plan.best_format, convert, plan.gain_per_iter, overhead_eff, kernel
        )

    # --------------------------------------------------------------- batched
    def optimize_many(
        self,
        mats: list[np.ndarray],
        objective: str = "latency",
        *,
        mode: str = "compile",
        **kwargs,
    ) -> list:
        """Tune a batch of matrices, deduplicated by content fingerprint.

        Each unique matrix is tuned once (feature extraction, plan lookup,
        kernel compile); duplicates receive the same result object. Results
        are returned in input order. ``mode`` is ``"compile"`` or ``"run"``;
        ``kwargs`` forward to the per-matrix optimize call.
        """
        if mode not in ("compile", "run"):
            raise ValueError(f"mode must be 'compile' or 'run', got {mode!r}")
        fps = [matrix_fingerprint(np.asarray(m)) for m in mats]
        unique: dict[str, object] = {}
        for fp, m in zip(fps, mats):
            if fp in unique:
                self.stats.requests += 1  # served entirely from the memo
                continue
            if mode == "compile":
                unique[fp] = self.compile_time_optimize(
                    m, objective, fingerprint=fp, **kwargs
                )
            else:
                unique[fp] = self.run_time_optimize(
                    m, objective, fingerprint=fp, **kwargs
                )
        log.info(
            "optimize_many: %d matrices -> %d unique (%s, %s)",
            len(mats),
            len(unique),
            mode,
            objective,
        )
        return [unique[fp] for fp in fps]

    # ------------------------------------------------------------ partitioned
    def _replay_partitioned(self, dense: np.ndarray, entry: CacheEntry):
        """Rebuild a ``CompositePlan`` for THIS matrix from a cached entry.

        The cached decisions are bucket-level (per-block format + schedule,
        in row order); the row boundaries are re-derived from this matrix's
        own nnz histogram, so a bucket-mate with a shifted hub row still gets
        balanced blocks. Returns None when the stored block count cannot be
        realized (fewer rows than blocks) — the caller re-plans."""
        from repro_torch.core.objectives import ObjectiveValues
        from repro_torch.partition.partitioner import partition_rows
        from repro_torch.partition.plan import BlockPlan, CompositePlan

        part = partition_rows(dense, entry.n_blocks)
        if part.n_blocks != entry.n_blocks or len(entry.blocks) != entry.n_blocks:
            return None
        plans = tuple(
            BlockPlan(
                block=blk,
                fmt=raw["fmt"],
                schedule=KernelSchedule(**raw["schedule"]),
                # replayed plans carry the stored latency estimate only;
                # full ObjectiveValues live with the entry that planned them
                modeled=ObjectiveValues(raw.get("latency", 0.0), 0.0, 0.0, 0.0),
                predicted_fmt=raw.get("predicted_fmt", raw["fmt"]),
            )
            for blk, raw in zip(part.blocks, entry.blocks)
        )
        modeled = ObjectiveValues(entry.predicted.get("latency", 0.0), 0.0, 0.0, 0.0)
        monolithic = ObjectiveValues(
            entry.predicted.get("monolithic_latency", 0.0), 0.0, 0.0, 0.0
        )
        return CompositePlan(
            entry.objective, part, plans, modeled, monolithic,
            entry.monolithic_fmt or default_format(),
        )

    def partitioned_optimize(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        max_blocks: int = 8,
        fused: bool = False,
        fingerprint: str | None = None,
    ) -> PartitionedResult:
        """Partitioned run-time mode through the plan cache.

        On a miss the tuner searches block counts {1, ..., max_blocks} and
        the winning composite plan (or the monolithic fallback) is cached
        per feature bucket; on a hit the stored per-block decisions replay
        onto this matrix's own nnz-balanced boundaries. Kernels compile
        through the process-wide memo, keyed per (matrix, row range).

        Planning uses the session's ``cost_model`` when one is set (a
        ``CalibratedCostModel`` after ``calibrate``), so block-count search
        charges the measured per-launch fixed cost; else the tuner's own. With
        ``fused=True`` the composite lowers to ONE launch
        (``compile_fused_partitioned``, one memo entry keyed on the whole
        plan) instead of per-block kernels — the fast serving path;
        per-block timing needs ``fused=False``."""
        from repro_torch.partition.executor import (
            compile_fused_partitioned,
            compile_partitioned,
        )
        from repro_torch.partition.partitioner import SUPPORTED_BLOCK_COUNTS

        self.stats.requests += 1
        with _span(
            "session.optimize", mode="partitioned", objective=objective, fused=fused
        ) as sp:
            fp, feats, bucket = self._analyze(dense, fingerprint)
            mode = _part_mode_key(max_blocks)
            with _span("cache.lookup", bucket=bucket, mode=mode):
                entry = self.cache.get(bucket, objective, mode)
            plan = self._replay_partitioned(dense, entry) if entry is not None else None
            cache_hit = plan is not None
            sp.set(bucket=bucket, cache_hit=cache_hit)
            if plan is None:
                block_counts = tuple(
                    k for k in SUPPORTED_BLOCK_COUNTS if k <= max_blocks
                ) or (1,)
                with _span("plan.compute", bucket=bucket, mode=mode):
                    plan = self.tuner.plan_partitioned(
                        dense, objective, block_counts=block_counts,
                        cost_model=self.cost_model,
                    )
                self.stats.plans_computed += 1
                self.stats.cache_misses += 1
                self.cache.put(
                    CacheEntry(
                        bucket=bucket,
                        objective=objective,
                        mode=mode,
                        fmt="+".join(plan.formats),
                        schedule=plan.blocks[0].schedule.as_dict(),
                        predicted={
                            "latency": plan.modeled.latency,
                            "monolithic_latency": plan.monolithic.latency,
                        },
                        n_blocks=plan.n_blocks,
                        blocks=[bp.as_dict() for bp in plan.blocks],
                        monolithic_fmt=plan.monolithic_fmt,
                    )
                )
                log.info(
                    "partitioned miss: bucket=%s -> k=%d formats=%s (gain %.1f%%)",
                    bucket,
                    plan.n_blocks,
                    "+".join(plan.formats),
                    100.0 * plan.gain(),
                )
            else:
                self.stats.cache_hits += 1
            before = kernel_memo_stats()["compiles"]
            compile_fn = compile_fused_partitioned if fused else compile_partitioned
            kernel = compile_fn(dense, plan, device=self.tuner.device, memo_key=fp)
            self.stats.kernel_compiles += kernel_memo_stats()["compiles"] - before
        return PartitionedResult(
            fingerprint=fp,
            features=feats,
            bucket=bucket,
            objective=objective,
            plan=plan,
            kernel=kernel,
            mode=mode,
            cache_hit=cache_hit,
        )

    def serve_partitioned(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        max_blocks: int = 8,
        fingerprint: str | None = None,
    ) -> PartitionedResult:
        """Partitioned serving with per-(block, format) bandit arms.

        Each block's cell (``block_arm_bucket``) consults the adaptive
        selector with the composite plan's block format as incumbent, so
        individual blocks explore and drift independently — block 2 can be
        re-routed to SELL while block 0 keeps its plan. An infeasible
        exploratory pick is disabled for that block's cell and the planned
        kernel serves instead (a probe failure is paid once, not per
        request). Without an adaptive selector this is exactly
        ``partitioned_optimize``."""
        base = self.partitioned_optimize(
            dense, objective, max_blocks=max_blocks, fingerprint=fingerprint
        )
        if self.adaptive is None:
            return base
        from dataclasses import replace as dc_replace

        from repro_torch.kernels.ops import compile_spmv_block
        from repro_torch.partition.executor import PartitionedSpmv
        from repro_torch.telemetry.adaptive import block_arm_bucket

        served, exploratory, kernels = [], [], list(base.kernel.blocks)
        for i, (bp, bk) in enumerate(zip(base.plan.blocks, base.kernel.blocks)):
            cell = block_arm_bucket(base.bucket, bp.block.index, base.n_blocks)
            prior = bp.modeled.latency if bp.modeled.latency > 0 else None
            fmt, explore = self.adaptive.choose(
                cell, objective, bp.fmt, format_names(), prior_value=prior
            )
            if fmt != bp.fmt:
                try:
                    before = kernel_memo_stats()["compiles"]
                    swapped = compile_spmv_block(
                        dense,
                        bp.block.row_start,
                        bp.block.row_end,
                        fmt,
                        bp.schedule,
                        device=self.tuner.device,
                        memo_key=base.fingerprint,
                    )
                    self.stats.kernel_compiles += (
                        kernel_memo_stats()["compiles"] - before
                    )
                    kernels[i] = dc_replace(bk, fmt=fmt, kernel=swapped)
                except Exception as exc:
                    log.warning(
                        "serve: %s infeasible for block %d of bucket %s (%s)",
                        fmt,
                        bp.block.index,
                        base.bucket,
                        exc,
                    )
                    self.adaptive.disable(cell, objective, fmt, fallback=bp.fmt)
                    fmt, explore = bp.fmt, False
            if explore:
                self.stats.explorations += 1
            served.append(fmt)
            exploratory.append(explore)
        kernel = PartitionedSpmv(kernels, base.plan.partition.n_rows)
        return PartitionedResult(
            fingerprint=base.fingerprint,
            features=base.features,
            bucket=base.bucket,
            objective=base.objective,
            plan=base.plan,
            kernel=kernel,
            mode=base.mode,
            cache_hit=base.cache_hit,
            served_formats=tuple(served),
            exploratory=tuple(exploratory),
        )

    def observe_partitioned(
        self, result: PartitionedResult, block_times_s: list[float]
    ) -> None:
        """Feed per-block measured wall times back: every (block, format)
        pair is its own telemetry/bandit arm, and a sustained drift verdict
        on ANY block evicts the composite plan for the bucket, so the next
        request re-plans (and the promoted block arm seeds its incumbent)."""
        if len(block_times_s) != result.n_blocks:
            raise ValueError(
                f"{len(block_times_s)} block times for {result.n_blocks} blocks"
            )
        self.stats.observations += 1
        if self.telemetry is None and self.adaptive is None:
            return
        from repro_torch.telemetry.adaptive import block_arm_bucket

        formats = result.formats
        for bp, fmt, dt in zip(result.plan.blocks, formats, block_times_s):
            cell = block_arm_bucket(result.bucket, bp.block.index, result.n_blocks)
            predicted = bp.modeled.latency if bp.modeled.latency > 0 else None
            explored = bool(
                result.exploratory[bp.block.index] if result.exploratory else False
            )
            if self.telemetry is not None:
                self.telemetry.observe(
                    bucket=cell,
                    objective=result.objective,
                    fmt=fmt,
                    measured_s=dt,
                    predicted_s=predicted if fmt == bp.fmt else None,
                    plan_id=f"{cell}/{result.objective}/{result.mode}",
                    exploratory=explored,
                    schedule=bp.schedule.as_dict(),
                    features=bp.block.features.dict(),
                )
            if self.adaptive is None:
                continue
            self.adaptive.update(
                cell,
                result.objective,
                fmt,
                dt,
                predicted_s=predicted if fmt == bp.fmt else None,
            )
            challenger = self.adaptive.review(cell, result.objective)
            if challenger is not None:
                dropped = self.invalidate(result.bucket, result.objective, result.mode)
                self.adaptive.promote(cell, result.objective, challenger)
                log.info(
                    "drift: block %d of bucket=%s obj=%s %s -> %s "
                    "(%d composite plan(s) dropped)",
                    bp.block.index,
                    result.bucket,
                    result.objective,
                    fmt,
                    challenger,
                    dropped,
                )

    # ----------------------------------------------------- telemetry serving
    def _incumbent_format(
        self, feats: SparsityFeatures, bucket: str, objective: str
    ) -> str:
        """The cached run-time plan's format — the bandit's incumbent arm.

        Computed (and cached) via ``plan_run_time`` on first sight, so the
        classifier's opinion is the arm the bandit starts from."""
        mode = _run_mode_key(default_format(), DEFAULT_SCHEDULE)
        entry = self.cache.peek(bucket, objective, mode)
        if entry is None:
            plan = self.tuner.plan_run_time(feats, objective)
            self.stats.plans_computed += 1
            entry = self.cache.put(
                CacheEntry(
                    bucket=bucket,
                    objective=objective,
                    mode=mode,
                    fmt=plan.best_format,
                    schedule=DEFAULT_SCHEDULE.as_dict(),
                    gain_per_iter=plan.gain_per_iter,
                    latency_gain_per_iter=plan.latency_gain_per_iter,
                    overhead_s=plan.overhead_s,
                    convert_overhead_s=plan.convert_overhead_s,
                )
            )
        return entry.fmt

    def _predicted_latency(
        self,
        feats: SparsityFeatures,
        bucket: str,
        objective: str,
        fmt: str,
        schedule: KernelSchedule,
    ) -> float | None:
        """Regressor latency estimate for (features, fmt, schedule), memoized
        per (bucket, objective, fmt) so serving pays one inference per arm."""
        key = (bucket, objective, fmt)
        cached = self._pred_memo.get(key)
        if cached is not None:
            return cached
        try:
            from repro_torch.core.tuning_space import TuningConfig

            est = float(
                self.tuner.predictor.estimate_objective(
                    feats, TuningConfig(fmt, schedule), "latency"
                )
            )
        except Exception:  # predictor without regressors: prior-less bandit
            return None
        self._pred_memo[key] = est
        return est

    def serve_optimize(
        self,
        dense: np.ndarray,
        objective: str = "latency",
        *,
        fingerprint: str | None = None,
    ) -> ServedPlan:
        """The telemetry-aware serving path: cached schedule + bandit format.

        The compile-time plan supplies the kernel schedule and objective
        estimates exactly as before; with an ``adaptive`` selector attached
        the *format* is the bandit's pick — the cached run-time plan as
        incumbent, alternates within the exploration budget. Without one
        this degrades to ``compile_time_optimize`` plus plan identity, so
        telemetry-only deployments record without changing any decision.
        """
        fp, feats, bucket = self._analyze(dense, fingerprint)
        key = self.plan_key(feats, objective)
        pre_existing = self.cache.peek(*key) is not None
        base = self.compile_time_optimize(dense, objective, fingerprint=fp)
        default_fmt = default_format()
        fmt, exploratory = default_fmt, False
        if self.adaptive is not None:
            incumbent = self._incumbent_format(feats, bucket, objective)
            fmt, exploratory = self.adaptive.choose(
                bucket,
                objective,
                incumbent,
                format_names(),
                prior_value=self._predicted_latency(
                    feats, bucket, objective, incumbent, base.schedule
                ),
            )
            if exploratory:
                self.stats.explorations += 1
        if fmt == default_fmt:
            kernel = base.kernel
        else:
            try:
                kernel = self._compile(dense, fp, fmt, base.schedule)
            except Exception as exc:
                # an exploratory format can be infeasible for this matrix
                # (storage blow-up, tile mismatch): serving must not fail on
                # a bandit probe — fall back to the compile-time default-
                # format kernel and retire the arm so the failure is paid
                # once, not per request
                log.warning(
                    "serve: %s infeasible for bucket %s (%s); serving %s",
                    fmt,
                    bucket,
                    exc,
                    default_fmt,
                )
                if self.adaptive is not None:
                    self.adaptive.disable(bucket, objective, fmt)
                fmt, exploratory, kernel = default_fmt, False, base.kernel
        return ServedPlan(
            fingerprint=fp,
            features=feats,
            bucket=bucket,
            objective=objective,
            fmt=fmt,
            schedule=base.schedule,
            kernel=kernel,
            predicted=dict(base.predicted),
            plan_id="/".join(key),
            exploratory=exploratory,
            cache_hit=pre_existing,
            predicted_s=self._predicted_latency(
                feats, bucket, objective, fmt, base.schedule
            ),
        )

    def observe(self, plan: ServedPlan, measured_s: float) -> None:
        """Feed one measured execution back: record, update the bandit, and
        evict the cached plan when drift is sustained (measure → relearn)."""
        self.stats.observations += 1
        predicted_s = plan.predicted_s
        if self.telemetry is not None:
            self.telemetry.observe(
                bucket=plan.bucket,
                objective=plan.objective,
                fmt=plan.fmt,
                measured_s=measured_s,
                predicted_s=predicted_s,
                plan_id=plan.plan_id,
                exploratory=plan.exploratory,
                schedule=plan.schedule.as_dict(),
                features=plan.features.dict(),
            )
        if self.adaptive is None:
            return
        self.adaptive.update(
            plan.bucket, plan.objective, plan.fmt, measured_s, predicted_s=predicted_s
        )
        challenger = self.adaptive.review(plan.bucket, plan.objective)
        if challenger is not None:
            dropped = self.invalidate(plan.bucket, plan.objective)
            self.adaptive.promote(plan.bucket, plan.objective, challenger)
            log.info(
                "drift: bucket=%s obj=%s %s -> %s (%d stale plans dropped)",
                plan.bucket,
                plan.objective,
                plan.fmt,
                challenger,
                dropped,
            )

    def invalidate(
        self, bucket: str, objective: str | None = None, mode: str | None = None
    ) -> int:
        """Evict cached plans for a bucket; the next request re-plans against
        the current predictors (which feedback may have refit meanwhile)."""
        dropped = self.cache.invalidate(bucket, objective, mode)
        if dropped:
            self.stats.invalidations += 1
        # the memoized regressor estimates belong to the evicted plans: a
        # refit predictor must be re-consulted for this bucket
        for key in [
            k
            for k in self._pred_memo
            if k[0] == bucket and (objective is None or k[1] == objective)
        ]:
            del self._pred_memo[key]
        return dropped

    def evict_format(self, fmt: str) -> int:
        """Invalidate every cached plan serving ``fmt`` — plans whose
        chosen format matches (a "+"-joined composite format string, as a
        cache written by a partitioned path carries, matches on any part).
        Targeted eviction: a lying cost model poisons exactly the plans
        scored with its estimates for that format, so only those re-plan."""
        dropped = 0
        for entry in list(self.cache.entries()):
            if fmt in (entry.fmt or "").split("+"):
                dropped += self.invalidate(entry.bucket, entry.objective, entry.mode)
        if dropped:
            log.info("evicted %d cached plan(s) serving format %s", dropped, fmt)
        return dropped

    # ----------------------------------------------------------- calibration
    def calibrate(self, *, save: bool = True, min_samples: int = 1):
        """Fit a ``CalibratedCostModel`` from accumulated telemetry.

        The recorder's (predicted_s, measured_s) pairs become per-format
        affine corrections; the fitted model replaces the session's
        ``cost_model`` so subsequent partition planning charges the measured
        per-launch cost. The corrections scale the model that scored the
        session's plans, the one the predictions came from: the session's
        ``cost_model`` (the base of a calibrated one), else the tuner's
        (``CardCostModel`` for a tuner ``build_tuner`` built on a card), else
        ``CostModel(H100_SXM)``; the hardware is that model's. Cached
        partitioned plans were scored
        by the old model and are evicted (any ``part:*`` mode, every bucket)
        — the next request re-plans against measured reality. Persisted as a
        sibling of the tuning cache so a restarted session auto-loads it.
        """
        if self.telemetry is None:
            raise ValueError("calibrate() requires a telemetry recorder")
        from repro_torch.core.objectives import H100_SXM, CalibratedCostModel, CostModel

        base = self.cost_model if self.cost_model is not None else getattr(
            self.tuner, "cost_model", None)
        if isinstance(base, CalibratedCostModel):
            base = base.base
        if base is None:
            base = CostModel(H100_SXM)
        model = CalibratedCostModel.fit_from_telemetry(self.telemetry, base.hw, base=base)
        model.corrections = {
            f: c for f, c in model.corrections.items() if c.samples >= min_samples
        }
        self.cost_model = model
        dropped = 0
        for entry in list(self.cache.entries()):
            if entry.mode.startswith("part:"):
                dropped += self.invalidate(entry.bucket, entry.objective, entry.mode)
        if save and self.cache_path is not None:
            model.save(_calibration_path(self.cache_path))
        log.info(
            "calibrated cost model: %d format(s), %d stale partitioned plan(s) "
            "dropped",
            len(model.corrections),
            dropped,
        )
        return model

    # ----------------------------------------------------------- persistence
    def save(self, path: str | Path | None = None) -> Path:
        """Persist the plan cache (kernels stay process-local)."""
        target = Path(path) if path is not None else self.cache_path
        if target is None:
            raise ValueError("no path given and session has no cache_path")
        return self.cache.save(target)


# Rows of a matrix at the size the card serves: chip_smoke.py cuts the
# paper's presets to it, and the LM's FFN matrices have 1,024-10,944 rows.
# A tuner labelled by the card's cost model learns there too; the reference
# trains and serves at its tiny ``scale`` (its kernels run interpreted).
SERVED_ROWS = 14_000
# of a tuner's matrices, how many give the card's §5.3 predictor a sample at
# the served size (a conversion there takes 0.2-2 s)
SERVED_OVERHEAD_MATRICES = 3


def served_matrix(name: str) -> np.ndarray:
    """Preset ``name`` cut to ``SERVED_ROWS`` rows (``generate_by_name`` at
    ``SERVED_ROWS / n``, capped at 1: a smaller preset stays whole)."""
    from repro_torch.sparse.generate import SUITE, generate_by_name

    n = SUITE[name].n
    return generate_by_name(name, scale=min(1.0, SERVED_ROWS / n), max_elems=n * n)


# Process-wide memos of the served-size samples, one entry per preset: each
# costs seconds (a 0.8 GB dense scan, the card model over every launch, or
# real conversions), and one process builds several tuners over the same
# presets (the CLIs, the LM engines). Their keys carry what the samples
# depend on: the size, the model's constants, the registered formats and
# the storage guard, or the device.
@lru_cache(maxsize=64)
def _served_records(name: str, rows: int, profile, hw, formats: tuple, max_storage: int):
    from repro_torch.core.dataset import collect_dataset
    from repro_torch.core.objectives import CardCostModel
    from repro_torch.core.tuning_space import full_space

    def one():
        dense = served_matrix(name)
        yield f"{name}@{dense.shape[0]}", dense

    return tuple(collect_dataset(matrices=one(), space=list(full_space(formats)),
                                 model=CardCostModel(profile, hw)).records)


@lru_cache(maxsize=64)
def _served_overhead(name: str, rows: int, device: torch.device, formats: tuple):
    from repro_torch.core.overhead import measure_served_overheads

    dense = served_matrix(name)
    return measure_served_overheads(dense, f"{name}@{dense.shape[0]}", device=device)


def default_cost_model(device: torch.device):
    """The model that labels a tuner on ``device``: the card's
    ``CardCostModel`` on a CUDA device, the reference-equal ``CostModel``
    elsewhere (every CPU parity test of plans depends on it)."""
    from repro_torch.core.objectives import CardCostModel, CostModel

    return CardCostModel() if device.type == "cuda" else CostModel()


def tuning_dataset(scale: float, names, n_extra: int, model):
    """``collect_dataset`` of ``names`` at ``scale`` and ``n_extra``
    augmentation matrices, labelled by ``model``; where ``model`` is the
    card's ``CardCostModel``, each of ``names`` also at the size the card
    serves (``SERVED_ROWS``, records of ``"<name>@<rows>"``), labelled by
    that model from the matrix's statistics alone: no conversion, no
    timing. ``meta["served"]`` lists those matrices."""
    import dataclasses

    from repro_torch.core.dataset import TuningDataset, TuningRecord, collect_dataset
    from repro_torch.core.objectives import INFEASIBLE, CardCostModel
    from repro_torch.core.tuning_space import TuningConfig, schedule_space
    from repro_torch.sparse import registry

    ds = collect_dataset(scale=scale, names=names, n_extra=n_extra, model=model)
    if not isinstance(model, CardCostModel):
        return ds
    # the card model prices the formats with a card launch and calls every
    # other point infeasible: those records are made here, so that a plugin
    # registered later does not relabel the priced formats
    formats = format_names()
    priced = tuple(f for f in formats if registry.get_format(f).card_work is not None
                   and registry.get_format(f).card_launch is not None)
    served = []
    for name in names:
        recs = _served_records(name, SERVED_ROWS, model.profile, model.hw, priced,
                               registry.MAX_STORAGE_BYTES)
        by_fmt: dict[str, list] = {}
        for r in recs:
            by_fmt.setdefault(r.config.fmt, []).append(dataclasses.replace(r))
        for fmt in formats:
            served += by_fmt.get(fmt) or [
                TuningRecord(recs[0].matrix, recs[0].features, TuningConfig(fmt, s),
                             INFEASIBLE.latency, INFEASIBLE.energy, INFEASIBLE.power,
                             INFEASIBLE.efficiency, INFEASIBLE.feasible, recs[0].source)
                for s in schedule_space()]
    matrices = list(dict.fromkeys(r.matrix for r in served))
    return TuningDataset(ds.records + served, {
        **ds.meta, "served": {"rows": SERVED_ROWS, "matrices": matrices},
        "n_matrices": ds.meta["n_matrices"] + len(matrices)})


def overhead_predictor(scale: float, names, model, device):
    """The §5.3 predictor a tuner on ``device`` gates conversions with: the
    reference's ``OverheadPredictor`` on ``measure_overheads`` of ``names``
    at ``scale``; where ``model`` is the card's ``CardCostModel``,
    ``CardOverheadPredictor`` on those samples and on the first
    ``SERVED_OVERHEAD_MATRICES`` of ``names`` at the served size
    (``measure_served_overheads``)."""
    from repro_torch.core.objectives import CardCostModel
    from repro_torch.core.overhead import (
        CardOverheadPredictor,
        OverheadPredictor,
        measure_overheads,
    )
    from repro_torch.sparse.generate import generate_by_name

    samples = [measure_overheads(generate_by_name(n, scale=scale), n, device=device)
               for n in names]
    if not isinstance(model, CardCostModel):
        return OverheadPredictor().fit(samples)
    served = [_served_overhead(n, SERVED_ROWS, device, tuple(format_names()))
              for n in names[:SERVED_OVERHEAD_MATRICES]]
    return CardOverheadPredictor().fit(samples + served)


def build_tuner(
    scale: float = 0.0015,
    names: tuple[str, ...] | None = None,
    n_extra: int = 4,
    *,
    fit_overhead: bool = True,
    device: str | torch.device | None = None,
    model=None,
) -> AutoSpMV:
    """Convenience: collect a small dataset, fit predictors + overhead model.

    The quickest self-contained way to stand up a session (launcher demos,
    benchmarks); library users with a persisted dataset should fit
    ``AutoSpmvPredictor`` themselves and pass it to ``AutoSpMV`` directly.
    ``device`` (``None`` = CUDA, raising where absent) is where the tuner's
    kernels and the overhead samples' conversions put their arrays.
    ``model`` labels the dataset and scores partitioned plans: by default
    the card's ``CardCostModel`` on a CUDA device and the reference-equal
    ``CostModel`` on the CPU (``default_cost_model``); either may be passed
    on either device. With the card's model the dataset and the §5.3
    predictor also learn at the size the card serves (``tuning_dataset``,
    ``overhead_predictor``).
    """
    from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
    from repro_torch.kernels.common import resolve_device
    from repro_torch.sparse.generate import MATRIX_NAMES

    device = resolve_device(device)
    if model is None:
        model = default_cost_model(device)
    names = tuple(names) if names is not None else MATRIX_NAMES[:8]
    with _span("tuner.build", scale=scale):
        with _span("tuner.dataset"):
            ds = tuning_dataset(scale, names, n_extra, model)
        with _span("tuner.fit"):
            pred = AutoSpmvPredictor(
                PredictorConfig(max_regressor_samples=1500, device=device)).fit(ds)
        overhead = None
        if fit_overhead:
            with _span("tuner.overhead"):
                overhead = overhead_predictor(scale, names, model, device)
    return AutoSpMV(pred, overhead, device=device, dataset=ds, cost_model=model)
