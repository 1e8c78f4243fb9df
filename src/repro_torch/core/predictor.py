"""Learned predictors: the classification / regression stage (paper §5.4).

Per optimization objective, Auto-SpMV trains:

* one *format* classifier (run-time mode): features -> best sparse format;
* one classifier per compile-time *knob* (compile-time mode, format fixed to
  CSR): features -> best knob value (tb_size/rows_per_block, maxrregcount/
  unroll, memory/x_residency, + the extras nnz_tile, accum_dtype);
* optionally, *regressors* estimating the objective value of an arbitrary
  (features, config) pair — used for gain estimation in the conversion
  decision and for the paper's Fig. 11 study.

Models come from the zoo (paper Table 1/4) and can be HPO-tuned (hpo.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dataset import TuningDataset
from repro_torch.core.features import SparsityFeatures
from repro_torch.core.hpo import tune_model
from repro_torch.core.tuning_space import ALL_KNOBS, KNOBS, TuningConfig
from repro_torch.kernels.common import KernelSchedule
from repro_torch.ml.metrics import accuracy_score
from repro_torch.ml.model_zoo import CLASSIFIER_ZOO, REGRESSOR_ZOO
from repro_torch.sparse.registry import default_format, format_names
from repro_torch.utils.logging import get_logger

log = get_logger("core.predictor")

OBJECTIVES = ("latency", "energy", "power", "efficiency")


def _feature_matrix(features_list: list[SparsityFeatures]) -> np.ndarray:
    return np.stack([f.log_vector() for f in features_list])


def _config_row(
    config: TuningConfig, fmt_names: tuple[str, ...] | None = None
) -> np.ndarray:
    s = config.schedule
    names = fmt_names if fmt_names is not None else format_names()
    # one-hot over the format vocabulary frozen at fit time: a format
    # registered *after* fitting encodes as all-zeros instead of shifting
    # the feature layout under a fitted regressor
    fmt_onehot = [1.0 if config.fmt == f else 0.0 for f in names]
    return np.array(
        fmt_onehot
        + [
            np.log2(s.rows_per_block),
            np.log2(s.nnz_tile),
            np.log2(s.unroll),
            1.0 if s.accum_dtype == "bfloat16" else 0.0,
            1.0 if s.x_residency == "stream" else 0.0,
        ]
    )


@dataclass
class PredictorConfig:
    model_name: str = "decision_tree"  # paper's winner (Table 5)
    # decision tree is the paper's winner for average power (Fig. 11) and is
    # CPU-cheap; benchmarks/fig11 sweeps the full regressor zoo incl. the
    # random forest that wins energy/efficiency.
    regressor_name: str = "decision_tree"
    regressor_max_depth: int | None = 14
    max_regressor_samples: int = 3000  # subsample cap for single-core fit
    tune: bool = False  # run TPE HPO per classifier (paper §5.4 step 3)
    n_trials: int = 12
    seed: int = 0


@dataclass
class AutoSpmvPredictor:
    config: PredictorConfig = field(default_factory=PredictorConfig)

    def fit(self, dataset: TuningDataset) -> "AutoSpmvPredictor":
        self.format_clf_: dict[str, object] = {}
        self.knob_clf_: dict[tuple[str, str], object] = {}
        self.regressor_: dict[str, object] = {}
        # freeze the format vocabulary for the regressors' config encoding
        self.format_names_: tuple[str, ...] = format_names()
        matrices = dataset.matrices

        feats, fmt_labels, knob_labels = [], {o: [] for o in OBJECTIVES}, {}
        for knob in ALL_KNOBS:
            for obj in OBJECTIVES:
                knob_labels[(obj, knob)] = []
        for m in matrices:
            feats.append(dataset.for_matrix(m)[0].features)
            for obj in OBJECTIVES:
                # run-time mode label: best format over the full space
                best_fmt = dataset.best_record(m, obj).config.fmt
                fmt_labels[obj].append(best_fmt)
                # compile-time mode labels: best knob values with the
                # default (held) format fixed
                best_cfg = dataset.best_record(
                    m, obj, formats=(default_format(),)
                ).config
                for knob in ALL_KNOBS:
                    field_, _ = KNOBS[knob]
                    knob_labels[(obj, knob)].append(
                        str(getattr(best_cfg.schedule, field_))
                    )
        X = _feature_matrix(feats)

        for obj in OBJECTIVES:
            self.format_clf_[obj] = self._fit_classifier(X, np.array(fmt_labels[obj]))
            for knob in ALL_KNOBS:
                y = np.array(knob_labels[(obj, knob)])
                self.knob_clf_[(obj, knob)] = self._fit_classifier(X, y)

        # regressors on the record set (features + config encoding); capped
        # subsample keeps single-core fit times in seconds
        recs = dataset.feasible()
        if len(recs) > self.config.max_regressor_samples:
            sel = np.random.default_rng(self.config.seed).choice(
                len(recs), self.config.max_regressor_samples, replace=False
            )
            recs = [recs[i] for i in sel]
        Xr = np.stack(
            [
                np.concatenate(
                    [r.features.log_vector(), _config_row(r.config, self.format_names_)]
                )
                for r in recs
            ]
        )
        for obj in OBJECTIVES:
            y = np.array([r.objective(obj) for r in recs])
            y = np.log(np.maximum(y, 1e-30))  # objectives span decades
            entry = REGRESSOR_ZOO[self.config.regressor_name]
            kw = dict(entry["defaults"])
            if "max_depth" in kw:
                kw["max_depth"] = self.config.regressor_max_depth
            reg = entry["ctor"](**kw)
            reg.fit(Xr, y)
            self.regressor_[obj] = reg
        return self

    # ------------------------------------------------------------------ fits
    def _fit_classifier(self, X: np.ndarray, y: np.ndarray):
        entry = CLASSIFIER_ZOO[self.config.model_name]
        if len(np.unique(y)) == 1:
            return _ConstantClassifier(y[0])
        kw = dict(entry["defaults"])
        if self.config.tune and len(y) >= 6:
            res = tune_model(
                entry,
                X,
                y,
                accuracy_score,
                n_trials=self.config.n_trials,
                cv=3,
                seed=self.config.seed,
            )
            kw.update(res.best_params)
        clf = entry["ctor"](**kw)
        clf.fit(X, y)
        return clf

    # -------------------------------------------------------------- predicts
    def predict_format(self, features: SparsityFeatures, objective: str) -> str:
        x = features.log_vector()[None, :]
        return str(self.format_clf_[objective].predict(x)[0])

    def predict_schedule(
        self, features: SparsityFeatures, objective: str
    ) -> KernelSchedule:
        x = features.log_vector()[None, :]
        kw = {}
        for knob, (field_, choices) in KNOBS.items():
            raw = str(self.knob_clf_[(objective, knob)].predict(x)[0])
            # decode back to the python type of the choice set
            decoded = next(c for c in choices if str(c) == raw)
            kw[field_] = decoded
        # unroll must divide nnz_tile; clamp if the per-knob predictions clash
        if kw["nnz_tile"] % kw["unroll"]:
            kw["unroll"] = 1
        return KernelSchedule(**kw)

    def estimate_objective(
        self, features: SparsityFeatures, config: TuningConfig, objective: str
    ) -> float:
        names = getattr(self, "format_names_", None)
        x = np.concatenate([features.log_vector(), _config_row(config, names)])[None, :]
        return float(np.exp(self.regressor_[objective].predict(x)[0]))


class _ConstantClassifier:
    """Degenerate single-class case (e.g. one knob value dominates)."""

    def __init__(self, value):
        self.value = value

    def fit(self, X, y):
        return self

    def predict(self, X):
        return np.array([self.value] * np.asarray(X).shape[0])
