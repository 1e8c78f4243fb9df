"""Gradient boosting classifier: multinomial deviance, regression-tree weak
learners (paper Table 1 space: n_estimators in {50,100,150,200}, learning
rate in {0.1, 0.01, 0.001})."""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import ClassifierMixin, Estimator, check_Xy
from repro_torch.ml.tree import DecisionTreeRegressor


def _softmax(z):
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


class GradientBoostingClassifier(Estimator, ClassifierMixin):
    def __init__(self, n_estimators=100, learning_rate=0.1, max_depth=3, seed=0):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.seed = seed

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        n, k = X.shape[0], len(self.classes_)
        onehot = np.zeros((n, k))
        onehot[np.arange(n), y_enc] = 1.0
        self.init_ = np.log(np.maximum(onehot.mean(axis=0), 1e-12))
        F = np.tile(self.init_, (n, 1))
        self.stages_: list[list[DecisionTreeRegressor]] = []
        rng = np.random.default_rng(self.seed)
        for _ in range(self.n_estimators):
            P = _softmax(F)
            residual = onehot - P  # negative gradient of multinomial deviance
            stage = []
            for c in range(k):
                tree = DecisionTreeRegressor(
                    max_depth=self.max_depth, seed=int(rng.integers(0, 2**31 - 1))
                )
                tree.fit(X, residual[:, c])
                F[:, c] += self.learning_rate * tree.predict(X)
                stage.append(tree)
            self.stages_.append(stage)
        return self

    def decision_function(self, X):
        X = np.asarray(X, dtype=np.float64)
        F = np.tile(self.init_, (X.shape[0], 1))
        for stage in self.stages_:
            for c, tree in enumerate(stage):
                F[:, c] += self.learning_rate * tree.predict(X)
        return F

    def predict_proba(self, X):
        return _softmax(self.decision_function(X))

    def predict(self, X):
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]
