"""Random forests: bootstrap-bagged CART trees with feature subsampling.

Paper Table 4 settings: 100 estimators, max depth 15 (classification) /
None (regression), criterion searched over {gini, entropy, log_loss}.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import ClassifierMixin, Estimator, RegressorMixin, check_Xy
from repro_torch.ml.tree import DecisionTreeClassifier, DecisionTreeRegressor


class _BaseForest(Estimator):
    def __init__(self, n_estimators=100, max_depth=None, max_features="sqrt", seed=0,
                 **tree_kw):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.max_features = max_features
        self.seed = seed
        self.tree_kw = tree_kw

    def _resolve_max_features(self, n_features: int):
        mf = self.max_features
        if mf is None:
            return n_features
        if mf == "sqrt":
            return max(int(np.sqrt(n_features)), 1)
        if mf == "log2":
            return max(int(np.log2(n_features)), 1)
        return min(int(mf), n_features)

    def _fit_bagged(self, X, y, make_tree):
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        self.trees_ = []
        for i in range(self.n_estimators):
            idx = rng.integers(0, n, size=n)  # bootstrap sample
            tree = make_tree(seed=int(rng.integers(0, 2**31 - 1)))
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self


class RandomForestClassifier(_BaseForest, ClassifierMixin):
    def __init__(self, criterion="gini", **kw):
        super().__init__(**kw)
        self.criterion = criterion

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_ = np.unique(y)
        mf = self._resolve_max_features(X.shape[1])

        def make_tree(seed):
            return DecisionTreeClassifier(
                criterion=self.criterion,
                max_depth=self.max_depth,
                max_features=mf,
                seed=seed,
                **self.tree_kw,
            )

        return self._fit_bagged(X, y, make_tree)

    def predict_proba(self, X):
        # trees were fit on the full label set (bootstraps may miss classes;
        # align by each tree's classes_)
        n_classes = len(self.classes_)
        index = {c: i for i, c in enumerate(self.classes_)}
        probs = np.zeros((np.asarray(X).shape[0], n_classes))
        for tree in self.trees_:
            p = tree.predict_proba(X)
            for j, c in enumerate(tree.classes_):
                probs[:, index[c]] += p[:, j]
        return probs / len(self.trees_)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class RandomForestRegressor(_BaseForest, RegressorMixin):
    def fit(self, X, y):
        X, y = check_Xy(X, y)
        mf = self._resolve_max_features(X.shape[1])

        def make_tree(seed):
            return DecisionTreeRegressor(
                max_depth=self.max_depth, max_features=mf, seed=seed, **self.tree_kw
            )

        return self._fit_bagged(X, y, make_tree)

    def predict(self, X):
        return np.mean([t.predict(X) for t in self.trees_], axis=0)
