"""Synthetic sparse-matrix suite mirroring the paper's 30 SuiteSparse matrices.

The container is offline, so SuiteSparse itself is unavailable. The paper
selected its matrices for (1) a wide range of n (14,340..1,489,752), (2) a
wide range of nnz (800,800..19,235,140) and (3) minimal similarity between
sparsity features (§6.1, Fig. 7). We reproduce those three properties with a
seeded generator: each Table-7 matrix name becomes a pattern preset whose
full-scale (n, nnz) equal the published values, and whose sparsity pattern
class (FEM/banded, power-law graph, block-structured, geometric, dense-row)
matches the real matrix's domain. A global ``scale`` shrinks n while
preserving avg_nnz so laptop-scale runs keep the feature *spread* of Fig. 7.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MatrixSpec:
    name: str
    n: int  # full-scale rows (paper value)
    nnz: int  # full-scale nonzeros (paper Table 7 value)
    pattern: str  # generator family
    seed: int

    @property
    def avg_nnz(self) -> float:
        return self.nnz / self.n


# name, n, nnz (paper Table 7, ascending nnz), pattern class
_SUITE_RAW = [
    ("shar_te2-b3", 200_200, 800_800, "bipartite"),
    ("rim", 22_560, 1_014_951, "fem"),
    ("bcsstk32", 44_609, 1_029_655, "fem"),
    ("il2010", 451_554, 1_082_232, "geometric"),
    ("viscorocks", 37_762, 1_162_244, "fem"),
    ("cant", 62_451, 2_034_917, "fem"),
    ("parabolic_fem", 525_825, 2_100_225, "banded"),
    ("pkustk04", 55_590, 2_137_125, "block"),
    ("apache2", 715_176, 2_766_523, "banded"),
    ("consph", 83_334, 3_046_907, "fem"),
    ("wiki-talk-temporal", 1_140_149, 3_309_592, "powerlaw"),
    ("amazon0601", 403_394, 3_387_388, "powerlaw"),
    ("Chevron3", 381_689, 3_413_113, "banded"),
    ("xenon2", 157_464, 3_866_688, "fem"),
    ("x104", 108_384, 5_138_004, "block"),
    ("crankseg_1", 52_804, 5_333_507, "fem"),
    ("Si87H76", 240_369, 5_451_000, "denserows"),
    ("Hamrle3", 1_447_360, 5_514_242, "banded"),
    ("pwtk", 217_918, 5_926_171, "fem"),
    ("Chevron4", 711_450, 6_376_412, "banded"),
    ("Hardesty1", 938_905, 6_539_157, "banded"),
    ("rgg_n_2_20_s0", 1_048_576, 6_891_620, "geometric"),
    ("crankseg_2", 63_838, 7_106_348, "fem"),
    ("CurlCurl_3", 1_219_574, 7_382_096, "banded"),
    ("human_gene2", 14_340, 9_041_364, "denserows"),
    ("af_shell6", 504_855, 9_046_865, "fem"),
    ("atmosmodm", 1_489_752, 10_319_760, "banded"),
    ("kim2", 456_976, 11_330_020, "banded"),
    ("test1", 392_908, 12_968_200, "powerlaw"),
    ("eu-2005", 862_664, 19_235_140, "powerlaw"),
]

# Post-Table-7 extensions: in SUITE (name-addressable everywhere) but NOT in
# MATRIX_NAMES, which stays the paper's exact 30-matrix §6.1 selection used
# for dataset collection. Append-only — seeds are positional and must not
# shift for either list.
_EXTRA_RAW = [
    # web adjacency for the PageRank/power-iteration solver workload
    ("webgraph", 875_713, 5_105_039, "webgraph"),
    # magnitude-pruned LM FFN projection for the sparse-serving workload
    # (full-scale shape of a 7B-class gate/up projection at ~8 kept weights
    # per row; scaled copies keep the unstructured-topk row statistics)
    ("pruned-ffn", 11_008, 88_064, "prunedffn"),
]

SUITE: dict[str, MatrixSpec] = {
    name: MatrixSpec(name, n, nnz, pattern, seed=i + 1)
    for i, (name, n, nnz, pattern) in enumerate(_SUITE_RAW + _EXTRA_RAW)
}

MATRIX_NAMES = tuple(name for name, *_ in _SUITE_RAW)


def _scatter(n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray, rng) -> np.ndarray:
    dense = np.zeros((n_rows, n_cols), dtype=np.float32)
    vals = rng.uniform(0.1, 1.0, size=rows.size).astype(np.float32)
    dense[rows, cols] = vals  # duplicates collapse; nnz is approximate, as documented
    return dense


def _row_major_expand(counts: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(counts.size), counts)


def _gen_banded(n: int, avg: float, rng) -> np.ndarray:
    band = max(int(avg * 2), 4)
    counts = np.clip(rng.normal(avg, avg * 0.1, size=n).astype(np.int64), 1, band)
    rows = _row_major_expand(counts)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.size)
    cols = np.clip(rows + offs, 0, n - 1)
    return _scatter(n, n, rows, cols, rng)


def _gen_fem(n: int, avg: float, rng) -> np.ndarray:
    # near-constant row counts, mostly banded with a few far couplings
    counts = np.clip(rng.normal(avg, max(avg * 0.05, 1.0), size=n).astype(np.int64), 1, None)
    rows = _row_major_expand(counts)
    band = max(int(avg * 3), 8)
    local = rng.integers(-band // 2, band // 2 + 1, size=rows.size)
    cols = np.clip(rows + local, 0, n - 1)
    far = rng.random(rows.size) < 0.05
    cols[far] = rng.integers(0, n, size=int(far.sum()))
    return _scatter(n, n, rows, cols, rng)


def _gen_powerlaw(n: int, avg: float, rng) -> np.ndarray:
    # Zipf row degrees: few hub rows, many near-empty rows (graph adjacency)
    raw = rng.zipf(1.7, size=n).astype(np.float64)
    counts = np.clip(raw * (avg / raw.mean()), 1, n // 2).astype(np.int64)
    rows = _row_major_expand(counts)
    cols = rng.integers(0, n, size=rows.size)
    return _scatter(n, n, rows, cols, rng)


def _gen_block(n: int, avg: float, rng) -> np.ndarray:
    # dense (br x bc) tiles scattered on a block grid (BELL-friendly)
    br, bc = 8, 8
    nbr, nbc = max(n // br, 1), max(n // bc, 1)
    blocks_per_row = max(int(round(avg / bc)), 1)
    dense = np.zeros((n, n), dtype=np.float32)
    for i in range(nbr):
        js = rng.integers(0, nbc, size=blocks_per_row)
        for j in js:
            r0, c0 = i * br, j * bc
            dense[r0 : r0 + br, c0 : c0 + bc] = rng.uniform(
                0.1, 1.0, size=(min(br, n - r0), min(bc, n - c0))
            )
    return dense


def _gen_geometric(n: int, avg: float, rng) -> np.ndarray:
    # random geometric graph: neighbors of grid-ordered points (narrow band
    # plus locality noise); row counts are Poisson-like
    counts = np.clip(rng.poisson(avg, size=n), 1, None)
    rows = _row_major_expand(counts)
    spread = max(int(np.sqrt(n)), 2)
    offs = (rng.normal(0, spread, size=rows.size)).astype(np.int64)
    cols = np.clip(rows + offs, 0, n - 1)
    return _scatter(n, n, rows, cols, rng)


def _gen_denseband(n: int, avg: float, rng) -> np.ndarray:
    # contiguous fully-dense diagonal band of width ~avg: every row has
    # exactly the same count and its nonzeros are consecutive columns. The
    # most ELL/BELL-friendly structure a matrix can have (uniform width,
    # dense tiles) — the "dense band" half of the partitioned-SpMV
    # heterogeneity studies.
    w = int(np.clip(int(avg), 1, n))
    starts = np.clip(np.arange(n) - w // 2, 0, n - w)
    # group starts so 8-row sublane slabs share a column offset (tile-dense)
    starts = (starts // 8) * 8
    rows = np.repeat(np.arange(n), w)
    cols = (starts[:, None] + np.arange(w)[None, :]).reshape(-1)
    dense = np.zeros((n, n), dtype=np.float32)
    dense[rows, cols] = rng.uniform(0.1, 1.0, size=rows.size).astype(np.float32)
    return dense


def _gen_denserows(n: int, avg: float, rng) -> np.ndarray:
    counts = np.clip(rng.normal(avg, avg * 0.3, size=n).astype(np.int64), 1, n - 1)
    rows = _row_major_expand(counts)
    cols = rng.integers(0, n, size=rows.size)
    return _scatter(n, n, rows, cols, rng)


def _gen_webgraph(n: int, avg: float, rng) -> np.ndarray:
    # directed web adjacency A[i, j] = weight of link j -> i (column j holds
    # node j's out-edges, the orientation PageRank multiplies): power-law
    # out-degrees with preferential attachment on the targets (hub *rows*),
    # plus ~2% dangling nodes (all-zero columns) so the solver's
    # dangling-mass redistribution is actually exercised
    raw = rng.zipf(1.9, size=n).astype(np.float64)
    out_deg = np.clip(raw * (avg / raw.mean()), 1, n // 2).astype(np.int64)
    dangling = rng.random(n) < 0.02
    out_deg[dangling] = 0
    cols = _row_major_expand(out_deg)  # source node per edge
    # preferential attachment: half the edges land on zipf-ranked hub
    # targets, half uniformly (keeps the graph connected enough to mix)
    n_edges = cols.size
    hub = rng.random(n_edges) < 0.5
    hub_targets = np.minimum(rng.zipf(1.5, size=n_edges) - 1, n - 1)
    uni_targets = rng.integers(0, n, size=n_edges)
    rows = np.where(hub, hub_targets, uni_targets).astype(np.int64)
    off_diag = rows != cols  # no self-links
    return _scatter(n, n, rows[off_diag], cols[off_diag], rng)


def _gen_prunedffn(n: int, avg: float, rng) -> np.ndarray:
    # magnitude-pruned LM FFN weight: global top-k over a Gaussian matrix.
    # Unlike the graph/FEM patterns the support is i.i.d. (no banding, no
    # hubs) but the row-count distribution is the binomial an unstructured
    # topk induces — tight around avg with no empty rows at these densities,
    # the regime the sparse LM serving path feeds through serve_optimize.
    from repro_torch.optim.compress import magnitude_prune

    w = rng.normal(size=(n, n)).astype(np.float32)
    pruned, _ = magnitude_prune(w, min(avg / n, 1.0))
    return pruned


def normalize_columns(dense: np.ndarray) -> np.ndarray:
    """Column-stochastic normalization: each nonzero column sums to 1.

    Zero columns (dangling nodes) are left zero — PageRank's recurrence
    redistributes their mass explicitly, so the operator must keep them
    visible rather than papering over them with a uniform column."""
    dense = np.asarray(dense, dtype=np.float32)
    sums = dense.sum(axis=0)
    safe = np.where(sums > 0, sums, 1.0)
    return dense / safe[None, :]


def _gen_bipartite(n: int, avg: float, rng) -> np.ndarray:
    # constant-degree structured stencil (simplicial boundary operator-like)
    k = max(int(avg), 1)
    stride = max(n // (k + 1), 1)
    base = np.arange(n)[:, None] + (np.arange(k) * stride)[None, :]
    rows = np.repeat(np.arange(n), k)
    cols = (base % n).reshape(-1)
    return _scatter(n, n, rows, cols.astype(np.int64), rng)


_PATTERNS = {
    "banded": _gen_banded,
    "fem": _gen_fem,
    "powerlaw": _gen_powerlaw,
    "block": _gen_block,
    "geometric": _gen_geometric,
    "denseband": _gen_denseband,
    "denserows": _gen_denserows,
    "bipartite": _gen_bipartite,
    "webgraph": _gen_webgraph,
    "prunedffn": _gen_prunedffn,
}

PATTERN_NAMES = tuple(_PATTERNS)


def generate_dense(spec: MatrixSpec, scale: float = 1.0, max_elems: int = 200_000_000) -> np.ndarray:
    """Materialize the (scaled) dense matrix for ``spec``.

    ``scale`` shrinks n (rows/cols) while holding avg_nnz fixed, except when
    avg_nnz would exceed the scaled n, in which case the density saturates
    (documented behaviour; affects only denserows presets at tiny scales).
    """
    n = max(int(spec.n * scale), 64)
    avg = min(spec.avg_nnz, n / 2)
    if n * n > max_elems:
        raise ValueError(
            f"{spec.name}: scaled dense size {n}x{n} exceeds max_elems={max_elems}; "
            "lower `scale`"
        )
    rng = np.random.default_rng(spec.seed)
    return _PATTERNS[spec.pattern](n, avg, rng)


def generate_by_name(name: str, scale: float = 1.0, **kwargs) -> np.ndarray:
    return generate_dense(SUITE[name], scale=scale, **kwargs)


def random_matrix(
    n: int, avg_nnz: float, pattern: str = "fem", seed: int = 0
) -> np.ndarray:
    """Free-form generator for tests and the dataset harness."""
    rng = np.random.default_rng(seed)
    return _PATTERNS[pattern](n, min(avg_nnz, n / 2), rng)
