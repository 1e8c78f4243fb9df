"""nnz-balanced row partitioning (the matrix side of partitioned SpMV).

Real matrices are locally heterogeneous: a FEM band stacked on a power-law
adjacency wants different formats in different row regions (Yang et al.,
"Fast SpMV on GPUs"; Li et al.'s adaptive SpMV/SpMSpV make the same case per
region). The partitioner splits the row range into ``n_blocks`` contiguous
blocks so each block can be planned and executed independently:

1. **Greedy nnz balance** — block boundaries land at the quantiles of the
   cumulative nnz curve, so every block carries ~``nnz/n_blocks`` nonzeros
   (row counts alone would leave one block holding every hub row).
2. **Segment-boundary refinement** — a local sweep nudges each internal
   boundary within its neighbours' span to the position that (a) minimizes
   the nnz imbalance of the two adjacent blocks and (b) among near-ties,
   snaps to the largest row-count discontinuity, so boundaries settle on
   structural seams (band -> power-law transitions) rather than mid-segment.

Each ``RowBlock`` carries its own Table-2 feature vector, computed from a
slice of the matrix's single nonzeros-per-row histogram
(``core.features.row_nnz_counts``) — the per-block ``f`` term is a slice,
not a fresh pass over the matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.features import (
    SparsityFeatures,
    features_from_row_counts,
    row_nnz_counts,
)

# refinement stops when a full sweep moves no boundary (or after this cap)
_MAX_REFINE_SWEEPS = 4
# a candidate boundary within this relative imbalance of the best one may
# win on row-count discontinuity instead (the "segment seam" tie-break)
_SEAM_TOLERANCE = 0.05

SUPPORTED_BLOCK_COUNTS = (1, 2, 4, 8)


@dataclass(frozen=True)
class RowBlock:
    """One contiguous row block with its own sparsity feature vector."""

    index: int
    row_start: int
    row_end: int  # exclusive
    nnz: int
    features: SparsityFeatures

    @property
    def n_rows(self) -> int:
        return self.row_end - self.row_start


@dataclass(frozen=True)
class RowPartition:
    """A full cover of ``[0, n_rows)`` by contiguous, disjoint row blocks."""

    n_rows: int
    n_cols: int
    blocks: tuple[RowBlock, ...]

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.blocks)

    def boundaries(self) -> tuple[int, ...]:
        """Internal boundaries only: (b_1, ..., b_{k-1})."""
        return tuple(b.row_start for b in self.blocks[1:])

    def imbalance(self) -> float:
        """max block nnz / ideal block nnz (1.0 = perfectly balanced)."""
        ideal = self.nnz / max(self.n_blocks, 1)
        if ideal <= 0:
            return 1.0
        return max(b.nnz for b in self.blocks) / ideal


def _greedy_boundaries(cum: np.ndarray, n_blocks: int) -> list[int]:
    """Quantile cuts of the cumulative-nnz curve, forced strictly increasing."""
    n_rows = cum.size
    total = int(cum[-1]) if n_rows else 0
    bounds: list[int] = []
    prev = 0
    for k in range(1, n_blocks):
        if total > 0:
            b = int(np.searchsorted(cum, k * total / n_blocks, side="left")) + 1
        else:  # all-empty rows: fall back to an even row split
            b = round(k * n_rows / n_blocks)
        # keep room for the remaining blocks on both sides
        b = max(b, prev + 1)
        b = min(b, n_rows - (n_blocks - k))
        bounds.append(b)
        prev = b
    return bounds


def _refine_boundaries(
    counts: np.ndarray, cum: np.ndarray, bounds: list[int]
) -> list[int]:
    """Sweep internal boundaries toward balance, snapping to segment seams."""
    edges = np.diff(counts.astype(np.float64)) if counts.size > 1 else np.zeros(0)

    def block_nnz(lo: int, hi: int) -> int:
        return int(cum[hi - 1] - (cum[lo - 1] if lo else 0)) if hi > lo else 0

    for _ in range(_MAX_REFINE_SWEEPS):
        moved = False
        for i in range(len(bounds)):
            lo = bounds[i - 1] if i else 0
            hi = bounds[i + 1] if i + 1 < len(bounds) else counts.size
            span = np.arange(lo + 1, hi)
            if span.size <= 1 or block_nnz(lo, hi) == 0:
                continue  # nothing to balance: keep the even split
            # imbalance of the two blocks adjacent to this boundary
            left = np.array([block_nnz(lo, b) for b in span], dtype=np.float64)
            right = np.array([block_nnz(b, hi) for b in span], dtype=np.float64)
            imbalance = np.abs(left - right)
            tol = float(imbalance.min()) + _SEAM_TOLERANCE * float(left[-1] + right[0])
            near = imbalance <= tol
            # among near-balanced candidates, prefer the sharpest row-count
            # discontinuity: boundary b sits between rows b-1 and b
            seam = np.abs(edges[span - 1])
            cur_idx = int(bounds[i] - (lo + 1))
            if near[cur_idx] and seam[cur_idx] >= seam[near].max():
                continue  # current boundary is already optimal: stay put
            pick = int(span[near][int(np.argmax(seam[near]))])
            if pick != bounds[i]:
                bounds[i] = pick
                moved = True
        if not moved:
            break
    return bounds


def partition_rows(
    dense: np.ndarray,
    n_blocks: int,
    *,
    row_counts: np.ndarray | None = None,
    refine: bool = True,
) -> RowPartition:
    """Split ``dense``'s rows into ``n_blocks`` nnz-balanced blocks.

    ``n_blocks`` is clamped to ``[1, n_rows]`` (a block must own at least
    one row), so asking for more blocks than rows degrades gracefully. An
    empty or all-zero matrix partitions by even row split. ``row_counts``
    lets callers reuse an already-computed histogram.
    """
    dense = np.asarray(dense)
    if dense.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {dense.shape}")
    n_rows, n_cols = dense.shape
    counts = (
        np.asarray(row_counts, dtype=np.int64)
        if row_counts is not None
        else row_nnz_counts(dense)
    )
    if counts.size != n_rows:
        raise ValueError(f"row_counts has {counts.size} entries for {n_rows} rows")
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    n_blocks = min(n_blocks, max(n_rows, 1))

    if n_rows == 0:
        block = RowBlock(0, 0, 0, 0, features_from_row_counts(counts, 0))
        return RowPartition(0, n_cols, (block,))

    cum = np.cumsum(counts)
    bounds = _greedy_boundaries(cum, n_blocks)
    if refine and bounds:
        bounds = _refine_boundaries(counts, cum, bounds)

    starts = [0] + bounds
    ends = bounds + [n_rows]
    blocks = tuple(
        RowBlock(
            index=i,
            row_start=s,
            row_end=e,
            nnz=int(counts[s:e].sum()),
            features=features_from_row_counts(counts[s:e], e - s),
        )
        for i, (s, e) in enumerate(zip(starts, ends))
    )
    return RowPartition(n_rows, n_cols, blocks)
