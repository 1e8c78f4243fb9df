"""Telemetry → dataset → refit: the relearn side of the feedback loop.

The paper's pipeline (§5.4, §6.1) improves its predictors by collecting
labelled (matrix × config) outcomes offline. In serving, the telemetry
recorder produces exactly that label material for free: every arm aggregate
is a measured outcome of one (features, format, schedule) cell. This module

1. exports arm aggregates as ``TuningRecord``s (``source="telemetry"``,
   unmeasured objectives NaN — the same convention ``measured_cpu`` records
   already use) and appends them to a ``TuningDataset``, so the offline
   pipeline can retrain from fleet traffic;
2. drives *incremental refit* of the format classifier: per (bucket,
   objective) cell with enough measured coverage, the measured-best format
   becomes a training label, merged with the base dataset's labels, and the
   classifier is refit through the same ``ml/model_zoo`` path the paper's
   offline stage uses.

``FeedbackLoop.maybe_refit`` gates on new-observation count so a server can
call it after every batch at negligible cost.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.dataset import TuningDataset, TuningRecord
from repro_torch.core.features import SparsityFeatures
from repro_torch.core.predictor import OBJECTIVES
from repro_torch.core.tuning_space import TuningConfig
from repro_torch.kernels.common import DEFAULT_SCHEDULE, KernelSchedule
from repro_torch.telemetry.recorder import TelemetryRecorder
from repro_torch.utils.logging import get_logger

log = get_logger("telemetry.feedback")


@dataclass
class FeedbackConfig:
    min_pulls: int = 2  # observations an arm needs before it can label
    min_formats: int = 2  # measured formats a cell needs to be informative
    label_weight: int = 3  # telemetry labels repeated this often vs base labels
    refit_every: int = 16  # new observations between maybe_refit() refits


def _schedule_of(raw: dict) -> KernelSchedule:
    return KernelSchedule(**raw) if raw else DEFAULT_SCHEDULE


def telemetry_records(
    recorder: TelemetryRecorder, *, min_pulls: int = 1
) -> list[TuningRecord]:
    """Arm aggregates as §5.4 dataset rows (latency measured, rest NaN)."""
    out: list[TuningRecord] = []
    for (bucket, objective, fmt), agg in sorted(recorder.arms().items()):
        if agg.stats.count < min_pulls:
            continue
        feats_raw = recorder.bucket_features(bucket)
        if not feats_raw:
            continue  # replayed from a log that predates feature capture
        out.append(
            TuningRecord(
                matrix=f"telemetry/{bucket}",
                features=SparsityFeatures(**feats_raw),
                config=TuningConfig(fmt, _schedule_of(agg.schedule)),
                latency=agg.stats.mean,
                energy=math.nan,
                power=math.nan,
                efficiency=math.nan,
                feasible=True,
                source=f"telemetry_{objective}",
            )
        )
    return out


@dataclass
class FeedbackLoop:
    """Glues a recorder to a predictor + dataset for online relearning."""

    recorder: TelemetryRecorder
    base_dataset: TuningDataset | None = None
    dataset_path: str | Path | None = None
    config: FeedbackConfig = field(default_factory=FeedbackConfig)
    refits: int = 0
    _last_refit_obs: int = field(default=0, repr=False)

    # ------------------------------------------------------------- dataset IO
    def export_dataset(self, dataset: TuningDataset | None = None) -> TuningDataset:
        """Append current telemetry records to ``dataset`` (or a fresh one);
        earlier telemetry rows for the same cells are superseded in place."""
        ds = dataset if dataset is not None else TuningDataset(meta={"source": "telemetry"})
        fresh = telemetry_records(self.recorder, min_pulls=1)
        fresh_keys = {(r.matrix, r.config.fmt, r.source) for r in fresh}
        ds.records = [
            r
            for r in ds.records
            if not (
                r.source.startswith("telemetry")
                and (r.matrix, r.config.fmt, r.source) in fresh_keys
            )
        ]
        ds.records.extend(fresh)
        ds.meta["telemetry_observations"] = self.recorder.total_observations()
        if self.dataset_path is not None:
            ds.save(self.dataset_path)
            log.info(
                "appended %d telemetry records -> %s (%d total)",
                len(fresh),
                self.dataset_path,
                len(ds),
            )
        return ds

    # ----------------------------------------------------------------- labels
    def _measured_labels(self, objective: str) -> tuple[list[SparsityFeatures], list[str]]:
        cfg = self.config
        by_bucket: dict[str, dict[str, float]] = {}
        for (bucket, obj, fmt), agg in self.recorder.arms().items():
            if obj != objective or agg.stats.count < cfg.min_pulls:
                continue
            by_bucket.setdefault(bucket, {})[fmt] = agg.stats.mean
        feats, labels = [], []
        for bucket, means in by_bucket.items():
            raw = self.recorder.bucket_features(bucket)
            if len(means) < cfg.min_formats or not raw:
                continue
            feats.append(SparsityFeatures(**raw))
            labels.append(min(means, key=means.get))
        return feats, labels

    @staticmethod
    def _base_labels(
        dataset: TuningDataset, objective: str
    ) -> tuple[list[SparsityFeatures], list[str]]:
        feats, labels = [], []
        for m in dataset.matrices:
            recs = dataset.for_matrix(m)
            if not any(r.feasible for r in recs):
                continue
            try:
                best = dataset.best_record(m, objective)
            except ValueError:
                continue
            feats.append(recs[0].features)
            labels.append(best.config.fmt)
        return feats, labels

    # ------------------------------------------------------------------ refit
    def refit_format_classifier(
        self, predictor, objectives: tuple[str, ...] = OBJECTIVES
    ) -> dict[str, int]:
        """Refit ``predictor.format_clf_[obj]`` from measured + base labels.

        Telemetry labels are repeated ``label_weight``× so a handful of real
        measurements can overrule a misfit prior without discarding the base
        dataset's coverage of unseen feature regions. Returns the number of
        telemetry labels used per refit objective.
        """
        used: dict[str, int] = {}
        for objective in objectives:
            t_feats, t_labels = self._measured_labels(objective)
            if not t_labels:
                continue
            feats = list(t_feats) * self.config.label_weight
            labels = list(t_labels) * self.config.label_weight
            if self.base_dataset is not None:
                b_feats, b_labels = self._base_labels(self.base_dataset, objective)
                feats.extend(b_feats)
                labels.extend(b_labels)
            X = np.stack([f.log_vector() for f in feats])
            y = np.array(labels)
            # same zoo/HPO path the offline §5.4 stage uses
            predictor.format_clf_[objective] = predictor._fit_classifier(X, y)
            used[objective] = len(t_labels)
        if used:
            self.refits += 1
            self._last_refit_obs = self.recorder.total_observations()
            log.info("refit format classifiers from telemetry: %s", used)
        return used

    def maybe_refit(self, predictor) -> dict[str, int]:
        """Refit when ``refit_every`` new observations accumulated."""
        new = self.recorder.total_observations() - self._last_refit_obs
        if new < self.config.refit_every:
            return {}
        return self.refit_format_classifier(predictor)
