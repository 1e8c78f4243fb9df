"""Sparsity-feature extraction (paper Table 2).

Eight features computed from the row-nonzero histogram of the input matrix:
``n, nnz, avg_nnz, var_nnz, ell_ratio, median, mode, std_nnz``. Selected by
the paper for (1) minimal run-time extraction cost and (2) reported
performance impact. Extraction is a host/CPU numpy computation — the paper
measures it as ``f_latency`` (Table 7), so this module is deliberately
side-effect-free and timeable.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, fields

import numpy as np

FEATURE_NAMES = (
    "n",
    "nnz",
    "avg_nnz",
    "var_nnz",
    "ell_ratio",
    "median",
    "mode",
    "std_nnz",
)


@dataclass(frozen=True)
class SparsityFeatures:
    n: float  # number of rows
    nnz: float  # number of nonzeros
    avg_nnz: float  # mean nonzeros per row
    var_nnz: float  # variance of nonzeros per row
    ell_ratio: float  # nnz / (n * max_nnz)  — ELL storage efficiency
    median: float  # median nonzeros per row
    mode: float  # most frequent nonzeros-per-row value
    std_nnz: float  # standard deviation of nonzeros per row

    def vector(self) -> np.ndarray:
        return np.array([getattr(self, f.name) for f in fields(self)], dtype=np.float64)

    def dict(self) -> dict[str, float]:
        return asdict(self)

    def log_vector(self) -> np.ndarray:
        """log1p-scaled vector — the learning-pipeline input representation.

        n and nnz span 5 decades across the suite (Fig. 7); log scaling keeps
        distance-based models (nearest centroid, RBF SVM) meaningful.
        """
        return np.log1p(np.maximum(self.vector(), 0.0))


def features_from_row_counts(counts: np.ndarray, n_rows: int) -> SparsityFeatures:
    """Compute Table-2 features from the nonzeros-per-row histogram."""
    counts = np.asarray(counts, dtype=np.int64)
    nnz = int(counts.sum())
    max_nnz = int(counts.max(initial=0))
    vals, freq = np.unique(counts, return_counts=True)
    mode = float(vals[np.argmax(freq)]) if vals.size else 0.0
    var = float(counts.var()) if counts.size else 0.0
    return SparsityFeatures(
        n=float(n_rows),
        nnz=float(nnz),
        avg_nnz=float(counts.mean()) if counts.size else 0.0,
        var_nnz=var,
        ell_ratio=float(nnz / (n_rows * max_nnz)) if max_nnz else 0.0,
        median=float(np.median(counts)) if counts.size else 0.0,
        mode=mode,
        std_nnz=float(np.sqrt(var)),
    )


def row_nnz_counts(dense: np.ndarray) -> np.ndarray:
    """Nonzeros per row of a dense-held matrix (int64, length ``n_rows``).

    The shared primitive under ``extract_features`` and the row partitioner
    (``repro_torch.partition``): both need the same histogram, and the partitioner
    derives every per-block feature vector from slices of this one array, so
    the Table-7 ``f`` cost is paid once per matrix, not once per block.
    """
    return (np.asarray(dense) != 0).sum(axis=1).astype(np.int64)


def extract_features(dense: np.ndarray) -> SparsityFeatures:
    """Table-2 features of a dense-held matrix (run-time mode step 1)."""
    dense = np.asarray(dense)
    return features_from_row_counts(row_nnz_counts(dense), dense.shape[0])


def features_from_csr_indptr(indptr: np.ndarray) -> SparsityFeatures:
    """Features straight from CSR row pointers (no densification)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    counts = np.diff(indptr)
    return features_from_row_counts(counts, counts.size)


def features_from_assignment_histogram(tokens_per_expert: np.ndarray) -> SparsityFeatures:
    """Features of an MoE token->expert assignment viewed as a sparse matrix.

    Rows = experts, nnz per row = tokens routed to that expert. This is the
    bridge that lets the paper's run-time mode select the MoE dispatch
    strategy (DESIGN.md §3): the routing histogram *is* the nnz-per-row
    histogram of the dispatch matrix.
    """
    t = np.asarray(tokens_per_expert, dtype=np.int64)
    return features_from_row_counts(t, t.size)
