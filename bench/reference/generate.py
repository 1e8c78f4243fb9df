"""The benchmark's inputs, drawn from a seed: a symmetric matrix of the
port's ``denserows`` family at a published count of nonzeros, and the
Gaussian weights of a dense FFN.

Both are drawn on the given device with a ``torch.Generator`` in a few large
calls, so set-up does not pay a host loop; the same seed on the same device
gives the same numbers. The strictly lower triangle is drawn by a frozen
copy of ``sparse/generate.py``'s ``_gen_denserows`` as it stood when the
benchmark was written (row lengths ``normal(avg, 0.3 * avg)`` truncated
toward zero and clipped to ``[1, n - 1]``, uniform column indices,
duplicates collapsed), each position folded below the diagonal, and cut to
the exact count by a draw without replacement; the diagonal is full and the
upper triangle mirrors the lower, values too (``uniform(0.1, 1.0)``). A
symmetric matrix file lists its lower triangle: a published count of the
stored entries is ``(nnz + n) / 2``, the matrix a product multiplies ``nnz``.

Nothing here imports the program: the reference and the program are handed
the same arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def symmetric_denserows_coo(n: int, nnz: int, gen: torch.Generator,
                           device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keys, vals)`` of a symmetric ``n x n`` matrix of exactly ``nnz``
    nonzeros (``nnz - n`` even): the full diagonal and ``(nnz - n) / 2``
    distinct positions below it, mirrored. ``keys`` are the sorted flat
    positions ``row * n + col`` (int64), ``vals`` their float32 values, equal
    at ``(i, j)`` and ``(j, i)``."""
    lower = (nnz - n) // 2
    if nnz < n or (nnz - n) % 2 or lower > n * (n - 1) // 2:
        raise ValueError(f"no symmetric {n} x {n} matrix with a full diagonal has {nnz} nonzeros")
    pairs, margin = n * (n - 1) // 2, 1.1
    while True:  # enough draws that `margin` times the count stay, folded and collapsed
        draws = -pairs * math.log1p(-min(margin * lower / pairs, 0.99))
        below = _folded_denserows(n, min(draws / (n - 1), n / 2), gen, device)
        if below.numel() >= lower:
            break
        margin *= 1.25  # small matrices only: a second draw, from the same generator
        if margin > 4:
            raise ValueError(f"{nnz} nonzeros are too dense for the denserows draw at n = {n}")
    below = below[torch.randperm(below.numel(), generator=gen, device=device)[:lower]]
    below = torch.sort(below).values
    vals = torch.empty(lower + n, dtype=torch.float32, device=device)
    vals.uniform_(0.1, 1.0, generator=gen)
    diag = torch.arange(n, device=device) * (n + 1)
    r, c = below // n, below % n
    keys = torch.cat([below, c * n + r, diag])
    vals = torch.cat([vals[:lower], vals[:lower], vals[lower:]])
    keys, order = torch.sort(keys)
    return keys, vals[order]


def _folded_denserows(n: int, avg: float, gen: torch.Generator, device) -> torch.Tensor:
    """The ``denserows`` draw at ``avg`` a row, each off-diagonal position
    folded below the diagonal: the distinct flat positions, sorted."""
    counts = torch.normal(avg, avg * 0.3, (n,), generator=gen, device=device)
    counts = counts.to(torch.int64).clamp_(1, n - 1)
    rows = torch.repeat_interleave(torch.arange(n, device=device), counts)
    cols = torch.randint(0, n, (rows.numel(),), generator=gen, device=device)
    off = rows != cols
    return torch.unique(torch.maximum(rows, cols)[off] * n + torch.minimum(rows, cols)[off])


def dense_from_coo(n_rows: int, n_cols: int, keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The dense float32 matrix the program takes on the host."""
    dense = np.zeros((n_rows, n_cols), dtype=np.float32)
    dense.reshape(-1)[keys] = vals
    return dense


def gaussian(shapes, std: float, gen: torch.Generator, device) -> list[torch.Tensor]:
    """float32 Gaussian tensors of ``shapes``, drawn in one call."""
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std)
    return [t.view(*s) for t, s in zip(torch.split(flat, sizes), shapes)]
