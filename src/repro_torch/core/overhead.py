"""Run-time overhead measurement + prediction (paper §5.3, §7.5, Fig. 6).

Total run-time-mode overhead = f_latency (feature extraction) + o_latency
(overhead prediction) + p_latency (format prediction) + c_latency
(conversion). f and c dominate and scale with the matrix; o and p are
constant-time model inferences. Auto-SpMV converts only when the predicted
gain over the remaining solver iterations exceeds the predicted overhead.

``OverheadPredictor`` is the reference's (a ridge per format, clamped at
0). ``CardOverheadPredictor`` is the card's: per format a fixed cost plus
the dense scan (n^2) plus the nonzeros, non-negative, so positive by
construction and rising with the matrix; it carries samples of the tiny
training matrices and a few at the sizes the card serves
(``measure_served_overheads``) to any served matrix.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.features import SparsityFeatures, extract_features
from repro_torch.core.objectives import _nnls
from repro_torch.kernels.common import DEFAULT_SCHEDULE, InfeasibleConfig, resolve_device
from repro_torch.ml.linear import Ridge
from repro_torch.sparse.formats import from_dense
from repro_torch.sparse.registry import format_names
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import _block

log = get_logger("core.overhead")


@dataclass(frozen=True)
class OverheadSample:
    matrix: str
    features: SparsityFeatures
    f_latency: float
    c_latency: dict[str, float]  # per target format


def measure_overheads(
    dense: np.ndarray, name: str = "?", *, device=None
) -> OverheadSample:
    """Wall-time the actual host-side feature extraction and conversions
    (each conversion ends with its arrays on ``device``; ``None`` = CUDA)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    feats = extract_features(dense)
    f_latency = time.perf_counter() - t0
    c_latency = {}
    for fmt in format_names():
        t0 = time.perf_counter()
        _block(from_dense(dense, fmt, device=device))
        c_latency[fmt] = time.perf_counter() - t0
    return OverheadSample(name, feats, f_latency, c_latency)


def measure_served_overheads(
    dense: np.ndarray, name: str = "?", *, device=None
) -> OverheadSample:
    """The overheads as run-time mode pays them on a served matrix: the
    feature pass, and per format the conversion of the default schedule's
    storage through ``compile_spmv`` (arrays on ``device``; ``None`` =
    CUDA), as a measured card collection keeps them (``meta["overhead"]``).
    A format whose storage guard refuses the matrix has no entry: the
    reference's ``measure_overheads`` would build that storage unguarded."""
    from repro_torch.kernels.ops import compile_spmv

    device = resolve_device(device)
    t0 = time.perf_counter()
    feats = extract_features(dense)
    f_latency = time.perf_counter() - t0
    c_latency = {}
    for fmt in format_names():
        t0 = time.perf_counter()
        try:
            _block(compile_spmv(dense, fmt, DEFAULT_SCHEDULE, device=device).mat)
        except InfeasibleConfig:
            continue
        c_latency[fmt] = time.perf_counter() - t0
    return OverheadSample(name, feats, f_latency, c_latency)


def overhead_samples(dataset) -> list[OverheadSample]:
    """The §5.3 samples a measured collection over the card's space took at
    its matrices' own sizes (``core.dataset.collect_dataset``,
    ``meta["overhead"]``), with no further conversion: per matrix its
    feature pass, and per format the conversion of the default schedule's
    geometry; a format whose storage the guard refused has none."""
    out = []
    for name, seen in dataset.meta.get("overhead", {}).items():
        feats = dataset.for_matrix(name)[0].features
        c_latency = {f: t for f, t in seen.get("conversion_s", {}).items() if t is not None}
        out.append(OverheadSample(name, feats, seen["features_s"], c_latency))
    return out


def _design_row(features: SparsityFeatures) -> np.ndarray:
    # overheads scale ~linearly in n and nnz; keep raw terms + log terms
    v = features.vector()
    return np.concatenate([v[:2] / 1e6, np.log1p(v)])


class OverheadPredictor:
    """Learned f_latency / c_latency estimators (one ridge per format)."""

    def __init__(self):
        self._f_model: Ridge | None = None
        self._c_models: dict[str, Ridge] = {}

    def fit(self, samples: list[OverheadSample]) -> "OverheadPredictor":
        X = np.stack([_design_row(s.features) for s in samples])
        self._f_model = Ridge(alpha=1e-3).fit(X, np.array([s.f_latency for s in samples]))
        # fit one model per format the samples actually measured (a plugin
        # registered after sampling has no c-latency column to learn from)
        fmts = sorted(set.intersection(*(set(s.c_latency) for s in samples)))
        for fmt in fmts:
            y = np.array([s.c_latency[fmt] for s in samples])
            self._c_models[fmt] = Ridge(alpha=1e-3).fit(X, y)
        return self

    def predict_f(self, features: SparsityFeatures) -> float:
        x = _design_row(features)[None, :]
        return float(max(self._f_model.predict(x)[0], 0.0))

    def predict_c(self, features: SparsityFeatures, fmt: str) -> float:
        x = _design_row(features)[None, :]
        model = self._c_models.get(fmt)
        if model is None:
            # format registered after the overhead samples were taken: be
            # conservative and charge the worst measured conversion cost
            return float(
                max(max(m.predict(x)[0] for m in self._c_models.values()), 0.0)
            )
        return float(max(model.predict(x)[0], 0.0))

    def total_overhead(
        self, features: SparsityFeatures, fmt: str, inference_latency: float = 2e-3
    ) -> float:
        """f + c + (o + p): o/p are constant model-inference costs (the
        paper measures ~20 ms on its host; ours are single ridge/tree
        inferences, defaulting to 2 ms)."""
        return self.predict_f(features) + self.predict_c(features, fmt) + 2 * inference_latency


def _size_terms(features: SparsityFeatures) -> np.ndarray:
    # a fixed cost, the host's scan of the dense input (n x n: the served
    # matrices are square) and the work per nonzero
    return np.array([1.0, features.n * features.n, features.nnz])


class _SizeLaw:
    """seconds = a + b n^2 + c nnz with a, b, c >= 0: non-negative least
    squares on relative error (``objectives._nnls``, as ``fit_card_profile``
    fits the card's kernels)."""

    def __init__(self, samples: list[tuple[SparsityFeatures, float]]):
        X = np.stack([_size_terms(f) for f, _ in samples])
        y = np.array([max(t, 1e-9) for _, t in samples])
        self.coef = _nnls(X / y[:, None], np.ones_like(y))

    def predict(self, features: SparsityFeatures) -> float:
        return float(_size_terms(features) @ self.coef)


class CardOverheadPredictor(OverheadPredictor):
    """f_latency / c_latency on the card's host: for the feature pass and
    for each format a sum of non-negative terms, a fixed cost, the scan of
    the dense input (n^2) and the nonzeros, each fitted on the samples
    that measured it (a served-size sample lacks the formats the storage
    guard refused). Positive, and rising with n and nnz, wherever it is
    asked, so samples of tiny matrices and a few at the served size carry
    it to the largest served matrices, where the reference's ridge,
    extrapolated, predicts 0 s (clamped) or a hundred times the cost. A
    format no sample measured is charged the dearest prediction of the
    others, as the reference does."""

    def fit(self, samples: list[OverheadSample]) -> "CardOverheadPredictor":
        self._f_model = _SizeLaw([(s.features, s.f_latency) for s in samples])
        self._c_models = {}
        for fmt in sorted({f for s in samples for f in s.c_latency}):
            self._c_models[fmt] = _SizeLaw(
                [(s.features, s.c_latency[fmt]) for s in samples if fmt in s.c_latency])
        return self

    def predict_f(self, features: SparsityFeatures) -> float:
        return self._f_model.predict(features)

    def predict_c(self, features: SparsityFeatures, fmt: str) -> float:
        model = self._c_models.get(fmt)
        if model is None:
            return max(m.predict(features) for m in self._c_models.values())
        return model.predict(features)
