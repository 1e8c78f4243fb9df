"""Non-linear (kernel) SVM, one-vs-rest, trained in the representer form.

The decision function f(x) = sum_i alpha_i K(x_i, x) + b is optimized by
full-batch subgradient descent on the L2-regularized hinge loss — a compact,
deterministic stand-in for libsvm's SMO that is accurate at the dataset
sizes used here (hundreds-to-thousands of rows). Kernels follow the paper's
search space (Table 1): linear, poly, rbf, sigmoid. ("precomputed" is
accepted by passing a Gram matrix directly.)
"""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import ClassifierMixin, Estimator, check_Xy


def _kernel_matrix(kind: str, A, B, gamma: float, degree: int, coef0: float):
    if kind == "linear":
        return A @ B.T
    if kind == "poly":
        return (gamma * (A @ B.T) + coef0) ** degree
    if kind == "rbf":
        a2 = (A**2).sum(axis=1)[:, None]
        b2 = (B**2).sum(axis=1)[None, :]
        return np.exp(-gamma * np.maximum(a2 + b2 - 2 * A @ B.T, 0.0))
    if kind == "sigmoid":
        return np.tanh(gamma * (A @ B.T) + coef0)
    if kind == "precomputed":
        return A
    raise ValueError(f"unknown kernel {kind!r}")


class NonlinearSVM(Estimator, ClassifierMixin):
    def __init__(self, kernel="rbf", C=1.0, degree=3, gamma="scale", coef0=0.0,
                 n_iter=300, lr=0.5, seed=0):
        self.kernel = kernel
        self.C = C
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.n_iter = n_iter
        self.lr = lr
        self.seed = seed

    def _gamma_value(self, X):
        if self.gamma == "scale":
            var = X.var()
            return 1.0 / (X.shape[1] * var) if var > 0 else 1.0
        if self.gamma == "auto":
            return 1.0 / X.shape[1]
        return float(self.gamma)

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.X_ = X
        self.classes_ = np.unique(y)
        self.gamma_ = self._gamma_value(X)
        K = _kernel_matrix(self.kernel, X, X, self.gamma_, self.degree, self.coef0)
        n = X.shape[0]
        n_cls = len(self.classes_)
        self.alpha_ = np.zeros((n_cls, n))
        self.b_ = np.zeros(n_cls)
        lam = 1.0 / (self.C * n)
        # Lipschitz-style step normalization: the hinge subgradient scales
        # with the Gram magnitude (large for unnormalized linear kernels)
        knorm = max(float(np.abs(np.diag(K)).mean()), 1.0)
        for ci, c in enumerate(self.classes_):
            t = np.where(y == c, 1.0, -1.0)
            alpha = np.zeros(n)
            b = 0.0
            for it in range(self.n_iter):
                f = K @ alpha + b
                margin = t * f
                viol = margin < 1.0
                # subgradient of mean hinge + lam/2 * alpha K alpha
                g_alpha = lam * (K @ alpha) - (K[:, viol] @ t[viol]) / n
                g_b = -t[viol].sum() / n
                step = self.lr / ((1.0 + 0.1 * it) * knorm)
                alpha -= step * g_alpha
                b -= step * g_b
            self.alpha_[ci], self.b_[ci] = alpha, b
        return self

    def decision_function(self, X):
        X = np.asarray(X, dtype=np.float64)
        K = _kernel_matrix(self.kernel, X, self.X_, self.gamma_, self.degree, self.coef0)
        return K @ self.alpha_.T + self.b_[None, :]

    def predict(self, X):
        scores = self.decision_function(X)
        if len(self.classes_) == 2:
            # one-vs-rest on 2 classes: pick larger margin (columns mirror)
            return self.classes_[np.argmax(scores, axis=1)]
        return self.classes_[np.argmax(scores, axis=1)]
