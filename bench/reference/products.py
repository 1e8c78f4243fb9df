"""Plain float64 products that the benchmark holds the program's answers
against, and the comparison that decides ``correct``.

The reference builds its own CSR of the matrix from the positions and values
the benchmark drew (``CsrReference``) and runs the FFN on the pruned weights
the benchmark handed the program (``gated_ffn``); it reads the program's
outputs only to judge them (``max_rel_err``)."""

from __future__ import annotations

import numpy as np


class CsrReference:
    """``A @ x`` in float64 over a CSR built from sorted flat positions
    ``keys = row * n_cols + col`` and their ``vals``."""

    def __init__(self, n_rows: int, n_cols: int, keys: np.ndarray, vals: np.ndarray):
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size and np.any(np.diff(keys) <= 0):
            raise ValueError("positions must be sorted and distinct")
        self.shape = (int(n_rows), int(n_cols))
        rows = keys // n_cols
        self.cols = keys % n_cols
        self.vals = np.asarray(vals, dtype=np.float64)
        self.indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n_rows), out=self.indptr[1:])

    def __matmul__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.shape[1],):
            raise ValueError(f"x of shape {x.shape} for a matrix of shape {self.shape}")
        prods = self.vals * x[self.cols]
        starts = self.indptr[:-1]
        y = np.zeros(self.shape[0], dtype=np.float64)
        full = starts < self.indptr[1:]
        if prods.size:
            y[full] = np.add.reduceat(prods, starts[full])
        return y


def dense_product(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``x @ w`` in float64, ``x: (tokens, d_in)``, ``w: (d_in, d_out)``."""
    return np.asarray(x, dtype=np.float64) @ np.asarray(w, dtype=np.float64)


def gated_ffn(x: np.ndarray, w_gate: np.ndarray, w_up: np.ndarray,
              w_down: np.ndarray) -> np.ndarray:
    """A SiLU-gated FFN in float64: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``
    with ``x: (tokens, d)``."""
    g = dense_product(x, w_gate)
    h = g / (1.0 + np.exp(-g)) * dense_product(x, w_up)
    return h @ np.asarray(w_down, dtype=np.float64)


def max_rel_err(y, y_ref) -> float:
    """The largest gap between an answer and the reference, over the
    largest magnitude of the reference, taken per output vector (the last
    axis) and maximised over the rest. ``inf`` where the shapes differ or an
    answer is not finite."""
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    if y.shape != y_ref.shape or not np.all(np.isfinite(y)):
        return float("inf")
    gap = np.abs(y - y_ref).max(axis=-1)
    scale = np.maximum(np.abs(y_ref).max(axis=-1), np.finfo(np.float64).tiny)
    return float(np.max(gap / scale))
