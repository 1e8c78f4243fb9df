"""Evaluation metrics: accuracy + macro-F1 for classification (paper Table
5), R² + MSE for regression (paper Fig. 11)."""

from __future__ import annotations

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else 0.0


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if labels is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    index = {l: i for i, l in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        cm[index[t], index[p]] += 1
    return cm


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    """Macro-averaged F1 (per-class F1, unweighted mean)."""
    cm = confusion_matrix(y_true, y_pred)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    if average == "macro":
        return float(f1.mean())
    if average == "weighted":
        w = cm.sum(axis=1) / max(cm.sum(), 1)
        return float((f1 * w).sum())
    raise ValueError(f"unknown average {average!r}")


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    return float(np.mean((y_true - y_pred) ** 2))


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    if ss_tot == 0:
        return 1.0 if ss_res == 0 else 0.0
    return float(1.0 - ss_res / ss_tot)
