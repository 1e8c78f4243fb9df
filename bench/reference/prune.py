"""Magnitude pruning, a frozen copy of the rule of the port's
``optim/compress.magnitude_prune``: keep exactly ``round(density * size)``
entries of largest magnitude, of equal magnitudes the earliest flat index,
and zero the rest. A pruned checkpoint is what a user brings to the sparse
engine; the benchmark makes one from its Gaussian weights with this rule."""

from __future__ import annotations

import numpy as np


def magnitude_prune(w: np.ndarray, density: float) -> np.ndarray:
    w = np.asarray(w, dtype=np.float32)
    size = int(w.size)
    k = int(round(float(density) * size))
    out = np.zeros_like(w)
    if k <= 0 or size == 0:
        return out
    if k >= size:
        return w.copy()
    mag = np.abs(w).reshape(-1)
    mag[np.isnan(mag)] = -1.0
    kth = np.partition(mag, size - k)[size - k]
    keep = mag > kth
    ties = np.flatnonzero(mag == kth)[: k - int(np.count_nonzero(keep))]
    keep[ties] = True
    out.reshape(-1)[keep] = w.reshape(-1)[keep]
    return out
