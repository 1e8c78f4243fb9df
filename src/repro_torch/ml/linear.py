"""Linear regression family (paper Table 4 regression zoo): Ridge, Bayesian
Ridge (evidence maximization), Lasso (coordinate descent), LARS."""

from __future__ import annotations

import numpy as np

from repro_torch.ml.base import Estimator, RegressorMixin, check_Xy


class _LinearBase(Estimator, RegressorMixin):
    def _center(self, X, y):
        self.x_mean_ = X.mean(axis=0)
        self.x_scale_ = np.where(X.std(axis=0) > 0, X.std(axis=0), 1.0)
        self.y_mean_ = y.mean()
        return (X - self.x_mean_) / self.x_scale_, y - self.y_mean_

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        Xs = (X - self.x_mean_) / self.x_scale_
        return Xs @ self.coef_ + self.y_mean_


class Ridge(_LinearBase):
    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        Xs, yc = self._center(X, y.astype(np.float64))
        d = Xs.shape[1]
        self.coef_ = np.linalg.solve(Xs.T @ Xs + self.alpha * np.eye(d), Xs.T @ yc)
        return self


class BayesianRidge(_LinearBase):
    """Evidence-maximization ridge (MacKay updates), sklearn-compatible
    hyperparameters (paper Table 4: n_iter=300, tol=1e-3)."""

    def __init__(self, n_iter: int = 300, tol: float = 1e-3):
        self.n_iter = n_iter
        self.tol = tol

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        Xs, yc = self._center(X, y.astype(np.float64))
        n, d = Xs.shape
        XtX, Xty = Xs.T @ Xs, Xs.T @ yc
        alpha = 1.0 / max(yc.var(), 1e-9)  # noise precision
        lam = 1.0  # weight precision
        coef = np.zeros(d)
        eig = np.linalg.eigvalsh(XtX)
        for _ in range(self.n_iter):
            A = lam * np.eye(d) + alpha * XtX
            coef_new = alpha * np.linalg.solve(A, Xty)
            gamma = np.sum(alpha * eig / (lam + alpha * eig))
            lam = gamma / max(coef_new @ coef_new, 1e-12)
            resid = yc - Xs @ coef_new
            alpha = max(n - gamma, 1e-9) / max(resid @ resid, 1e-12)
            if np.max(np.abs(coef_new - coef)) < self.tol:
                coef = coef_new
                break
            coef = coef_new
        self.coef_ = coef
        self.alpha_, self.lambda_ = alpha, lam
        return self


class Lasso(_LinearBase):
    """L1 regression via cyclic coordinate descent (paper: alpha=1.0,
    1000 epochs)."""

    def __init__(self, alpha: float = 1.0, n_iter: int = 1000, tol: float = 1e-6):
        self.alpha = alpha
        self.n_iter = n_iter
        self.tol = tol

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        Xs, yc = self._center(X, y.astype(np.float64))
        n, d = Xs.shape
        coef = np.zeros(d)
        col_sq = (Xs**2).sum(axis=0)
        resid = yc.copy()
        lam = self.alpha * n
        for _ in range(self.n_iter):
            max_delta = 0.0
            for j in range(d):
                if col_sq[j] == 0:
                    continue
                rho = Xs[:, j] @ resid + col_sq[j] * coef[j]
                new = np.sign(rho) * max(abs(rho) - lam, 0.0) / col_sq[j]
                delta = new - coef[j]
                if delta != 0.0:
                    resid -= delta * Xs[:, j]
                    coef[j] = new
                    max_delta = max(max_delta, abs(delta))
            if max_delta < self.tol:
                break
        self.coef_ = coef
        return self


class Lars(_LinearBase):
    """Least-Angle Regression (paper Table 4: max 500 nonzero coefs)."""

    def __init__(self, n_nonzero_coefs: int = 500, eps: float = np.finfo(float).eps):
        self.n_nonzero_coefs = n_nonzero_coefs
        self.eps = eps

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        Xs, yc = self._center(X, y.astype(np.float64))
        n, d = Xs.shape
        coef = np.zeros(d)
        active: list[int] = []
        resid = yc.copy()
        k_max = min(self.n_nonzero_coefs, d, n - 1 if n > 1 else 1)
        for _ in range(k_max):
            c = Xs.T @ resid
            inactive = [j for j in range(d) if j not in active]
            if not inactive:
                break
            j_new = inactive[int(np.argmax(np.abs(c[inactive])))]
            if abs(c[j_new]) < 10 * self.eps:
                break
            active.append(j_new)
            Xa = Xs[:, active]
            # equiangular least-squares step on the active set
            try:
                beta = np.linalg.lstsq(Xa, yc, rcond=None)[0]
            except np.linalg.LinAlgError:
                break
            # step fully toward LS solution of active set (LARS-OLS hybrid)
            coef = np.zeros(d)
            coef[active] = beta
            resid = yc - Xs @ coef
            if np.linalg.norm(resid) < 10 * self.eps:
                break
        self.coef_ = coef
        return self
