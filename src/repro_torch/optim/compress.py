"""Magnitude pruning for the sparse-serving path.

The reference module also holds top-k gradient compression with error
feedback (``compress_gradients``, ``_topk_sparsify``,
``init_error_feedback``); that is training code and waits for the training
slice of the port. ``magnitude_prune`` is pure numpy and keeps the
reference's result bit for bit; it selects the k-th magnitude with
``np.partition`` (linear time) where the reference sorts every entry, which
is what pruning an LM's FFN and expert matrices on the host costs.
"""

from __future__ import annotations

import numpy as np


def magnitude_prune(w: np.ndarray, density: float) -> tuple[np.ndarray, float]:
    """Export a magnitude-pruned weight as a dense array + density stat.

    Keeps exactly ``k = round(density * size)`` entries with the largest
    magnitudes (deterministic tie-break: the earlier flat index wins — an
    exact-k contract) and zeroes the rest. ``density <= 0`` zeroes
    everything; ``density >= 1`` returns a float32 copy unchanged. Returns
    ``(pruned float32 array, achieved density)`` — the achieved density can
    fall below the request when the input already holds zeros among its
    top-k magnitudes.
    """
    w = np.asarray(w, dtype=np.float32)
    size = int(w.size)
    if size == 0:
        return w.copy(), 0.0
    if density >= 1.0:
        return w.copy(), float(np.count_nonzero(w)) / size
    out = np.zeros_like(w)
    k = int(round(float(density) * size))
    if k <= 0:
        return out, 0.0
    mag = np.abs(w).reshape(-1)
    mag[np.isnan(mag)] = -1.0  # below every magnitude: last, as in the reference's sort
    out_flat, w_flat = out.reshape(-1), w.reshape(-1)
    # the k-th largest magnitude; every larger one is kept, and of those
    # equal to it the earliest flat indices (the stable sort's tie-break)
    kth = np.partition(mag, size - k)[size - k]
    keep = mag > kth
    ties = np.flatnonzero(mag == kth)[: k - int(np.count_nonzero(keep))]
    keep[ties] = True
    out_flat[keep] = w_flat[keep]
    return out, float(np.count_nonzero(out)) / size
