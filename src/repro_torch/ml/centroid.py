"""Nearest-centroid classifier (paper Table 1: metric in
{manhattan, euclidean, minkowski})."""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import ClassifierMixin, Estimator, check_Xy


class NearestCentroid(Estimator, ClassifierMixin):
    def __init__(self, metric: str = "euclidean", p: float = 3.0):
        if metric not in ("manhattan", "euclidean", "minkowski"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.p = p  # minkowski order

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_ = np.unique(y)
        self.centroids_ = np.stack([X[y == c].mean(axis=0) for c in self.classes_])
        return self

    def _dist(self, X):
        diff = X[:, None, :] - self.centroids_[None, :, :]
        if self.metric == "manhattan":
            return np.abs(diff).sum(axis=-1)
        if self.metric == "euclidean":
            return np.sqrt((diff**2).sum(axis=-1))
        return (np.abs(diff) ** self.p).sum(axis=-1) ** (1.0 / self.p)

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        return self.classes_[np.argmin(self._dist(X), axis=1)]
