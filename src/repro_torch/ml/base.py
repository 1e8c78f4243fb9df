"""Estimator plumbing shared by the from-scratch models."""

from __future__ import annotations

import numpy as np


class Estimator:
    """Minimal fit/predict protocol. Subclasses set ``fitted_`` in fit()."""

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Estimator":  # pragma: no cover
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def get_params(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.endswith("_")}

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({args})"


class ClassifierMixin:
    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


class RegressorMixin:
    def score(self, X, y) -> float:
        from repro_torch.ml.metrics import r2_score

        return r2_score(y, self.predict(X))


class StandardScaler:
    """Per-feature standardization (fit on train, reuse on validation)."""

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        self.scale_ = X.std(axis=0)
        self.scale_[self.scale_ == 0] = 1.0
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)


def train_test_split(X, y, test_size: float = 0.2, seed: int = 0):
    """Shuffled split — the paper uses 80/20 (§6.4)."""
    X, y = np.asarray(X), np.asarray(y)
    n = X.shape[0]
    idx = np.random.default_rng(seed).permutation(n)
    n_test = max(int(round(n * test_size)), 1)
    test, train = idx[:n_test], idx[n_test:]
    return X[train], X[test], y[train], y[test]


def check_Xy(X, y):
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D, got {X.shape}")
    if y.shape[0] != X.shape[0]:
        raise ValueError(f"X/y length mismatch: {X.shape[0]} vs {y.shape[0]}")
    return X, y
