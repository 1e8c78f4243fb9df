"""CART decision trees (classifier + regressor), from scratch.

The decision tree is the paper's best classifier (Table 5: 100 % accuracy
after tuning, depth=13); criteria and splitter follow the paper's search
space (Table 1: criterion in {gini, entropy, log_loss}, splitter in
{best, random}).

Split search is vectorized per feature: sort the column once, build prefix
class-count (or sum/sumsq) tables, and evaluate the impurity decrease at
every boundary between distinct values in O(n) after the sort.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import ClassifierMixin, Estimator, RegressorMixin, check_Xy

_EPS = 1e-12


def _gini(counts: np.ndarray) -> np.ndarray:
    # counts: (..., n_classes) -> impurity (...)
    tot = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(tot, _EPS)
    return 1.0 - (p**2).sum(axis=-1)


def _entropy(counts: np.ndarray) -> np.ndarray:
    tot = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(tot, _EPS)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = np.where(p > 0, np.log2(np.maximum(p, _EPS)), 0.0)
    return -(p * logp).sum(axis=-1)


# sklearn's "log_loss" criterion is entropy up to the log base
_CRITERIA = {"gini": _gini, "entropy": _entropy, "log_loss": _entropy}


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = value  # class-probability vector or mean

    @property
    def is_leaf(self):
        return self.left is None


class _BaseTree(Estimator):
    def __init__(self, max_depth=None, min_samples_split=2, min_samples_leaf=1,
                 splitter="best", max_features=None, seed=0):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.splitter = splitter
        self.max_features = max_features
        self.seed = seed

    # --- subclass hooks -------------------------------------------------
    def _leaf_value(self, y):  # pragma: no cover
        raise NotImplementedError

    def _impurity_gain(self, x_sorted, y_sorted):  # pragma: no cover
        """Return (best_gain, best_threshold) for one feature column."""
        raise NotImplementedError

    # --- shared fit/predict ---------------------------------------------
    def _fit_arrays(self, X, y):
        self.n_features_ = X.shape[1]
        rng = np.random.default_rng(self.seed)
        max_feats = self.max_features or self.n_features_
        depth_cap = self.max_depth if self.max_depth is not None else np.inf

        def build(idx, depth):
            node = _Node(self._leaf_value(y[idx]))
            if (
                depth >= depth_cap
                or idx.size < self.min_samples_split
                or self._is_pure(y[idx])
            ):
                return node
            feats = (
                rng.choice(self.n_features_, size=max_feats, replace=False)
                if max_feats < self.n_features_
                else np.arange(self.n_features_)
            )
            if self.splitter == "random":
                feats = rng.permutation(feats)
            best = (0.0, -1, 0.0)  # gain, feature, threshold
            for f in feats:
                col = X[idx, f]
                order = np.argsort(col, kind="stable")
                gain, thr = self._impurity_gain(col[order], y[idx][order])
                if gain > best[0] + _EPS:
                    best = (gain, f, thr)
                    if self.splitter == "random" and gain > 0:
                        break  # first improving feature, à la random splitter
            gain, f, thr = best
            if f < 0:
                return node
            mask = X[idx, f] <= thr
            li, ri = idx[mask], idx[~mask]
            if li.size < self.min_samples_leaf or ri.size < self.min_samples_leaf:
                return node
            node.feature, node.threshold = int(f), float(thr)
            node.left = build(li, depth + 1)
            node.right = build(ri, depth + 1)
            return node

        self.root_ = build(np.arange(X.shape[0]), 0)
        return self

    def _predict_values(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = []
        for row in X:
            node = self.root_
            while not node.is_leaf:
                node = node.left if row[node.feature] <= node.threshold else node.right
            out.append(node.value)
        return np.asarray(out)

    def depth(self) -> int:
        def d(node):
            return 0 if node.is_leaf else 1 + max(d(node.left), d(node.right))

        return d(self.root_)


class DecisionTreeClassifier(_BaseTree, ClassifierMixin):
    def __init__(self, criterion="gini", **kw):
        super().__init__(**kw)
        if criterion not in _CRITERIA:
            raise ValueError(f"criterion must be one of {sorted(_CRITERIA)}")
        self.criterion = criterion

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        self._imp = _CRITERIA[self.criterion]
        return self._fit_arrays(X, y_enc)

    def _is_pure(self, y):
        return np.all(y == y[0])

    def _leaf_value(self, y):
        return np.bincount(y, minlength=self.n_classes_) / max(y.size, 1)

    def _impurity_gain(self, x_sorted, y_sorted):
        n = y_sorted.size
        onehot = np.zeros((n, self.n_classes_))
        onehot[np.arange(n), y_sorted] = 1.0
        left = np.cumsum(onehot, axis=0)  # counts left of boundary i (inclusive)
        total = left[-1]
        # candidate boundaries: positions where x changes
        change = np.nonzero(np.diff(x_sorted) > _EPS)[0]
        if change.size == 0:
            return 0.0, 0.0
        nl = (change + 1).astype(np.float64)
        nr = n - nl
        cl = left[change]
        cr = total[None, :] - cl
        parent = self._imp(total[None, :])[0]
        child = (nl * self._imp(cl) + nr * self._imp(cr)) / n
        gains = parent - child
        k = int(np.argmax(gains))
        thr = 0.5 * (x_sorted[change[k]] + x_sorted[change[k] + 1])
        return float(gains[k]), float(thr)

    def predict_proba(self, X):
        return self._predict_values(X)

    def predict(self, X):
        return self.classes_[np.argmax(self._predict_values(X), axis=1)]


class DecisionTreeRegressor(_BaseTree, RegressorMixin):
    """Variance-reduction (MSE) regression tree."""

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        return self._fit_arrays(X, y.astype(np.float64))

    def _is_pure(self, y):
        return y.size <= 1 or np.ptp(y) < _EPS

    def _leaf_value(self, y):
        return float(y.mean()) if y.size else 0.0

    def _impurity_gain(self, x_sorted, y_sorted):
        n = y_sorted.size
        csum = np.cumsum(y_sorted)
        csum2 = np.cumsum(y_sorted**2)
        change = np.nonzero(np.diff(x_sorted) > _EPS)[0]
        if change.size == 0:
            return 0.0, 0.0
        nl = (change + 1).astype(np.float64)
        nr = n - nl
        sl, sl2 = csum[change], csum2[change]
        sr, sr2 = csum[-1] - sl, csum2[-1] - sl2
        var_l = sl2 - sl**2 / nl
        var_r = sr2 - sr**2 / np.maximum(nr, _EPS)
        parent = csum2[-1] - csum[-1] ** 2 / n
        gains = (parent - (var_l + var_r)) / n
        k = int(np.argmax(gains))
        thr = 0.5 * (x_sorted[change[k]] + x_sorted[change[k] + 1])
        return float(gains[k]), float(thr)

    def predict(self, X):
        return self._predict_values(X)
