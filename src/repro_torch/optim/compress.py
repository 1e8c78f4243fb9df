"""Top-k gradient compression with error feedback (Stich et al. 2018), and
magnitude pruning for the sparse-serving path.

Top-k sparsification with error feedback keeps convergence while cutting
the bytes a data-parallel reduce exchanges by ~1/k. It is applied at the
optimizer boundary (``train.trainer.make_train_step(compress_frac=...)``):
exact in semantics, the residual carried forward in the error feedback.

``magnitude_prune`` is pure numpy and keeps the reference's result bit for
bit; it selects the k-th magnitude with ``np.partition`` (linear time)
where the reference sorts every entry, which is what pruning an LM's FFN
and expert matrices on the host costs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.param import tree_map, tree_unflatten


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _kth_largest(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest entry of the 1-d ``a`` (a 0-d tensor): the least of
    the unsorted top k. The reference takes the last of ``lax.top_k``'s
    sorted values; the value is the same. On the card this skips the sort of
    k values (15.6 M at qwen3-0.6b's embedding with frac 0.1), and
    ``torch.kthvalue`` selects a single slice within one thread block."""
    return torch.topk(a, k, sorted=False).values.amin()


def _topk_sparsify(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-``frac`` fraction of entries by magnitude.

    ``frac <= 0`` keeps nothing (the error feedback then carries the full
    gradient forward), ``frac >= 1`` — or any ``frac`` whose k covers the
    whole tensor — returns ``g`` unchanged, and any positive ``frac`` keeps
    at least one entry. Ties at the threshold magnitude are ALL kept (the
    compare is ``>=``), so the realized density can exceed ``frac`` on
    heavily tied tensors, as in the reference.
    """
    if frac <= 0.0:
        return torch.zeros_like(g)
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    if k >= flat.shape[0]:
        return g
    thresh = _kth_largest(torch.abs(flat), k)
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


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


@torch.no_grad()
def compress_gradients(
    grads: Any, error: Any, frac: float = 0.1
) -> tuple[Any, Any, dict]:
    """Returns (compressed grads, new error feedback, metrics)."""
    comp, new_err = [], []

    def one(g, e):
        g32 = g.float() + e
        sparse = _topk_sparsify(g32, frac)
        comp.append(sparse)
        new_err.append(g32 - sparse)

    tree_map(one, grads, error)
    nnz = torch.stack([torch.count_nonzero(c) for c in comp]).sum().float()
    tot = sum(c.numel() for c in comp)
    return (tree_unflatten(grads, comp), tree_unflatten(grads, new_err),
            {"compress_density": nnz / tot})
