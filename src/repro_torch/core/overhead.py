"""Run-time overhead measurement + prediction (paper §5.3, §7.5, Fig. 6).

Total run-time-mode overhead = f_latency (feature extraction) + o_latency
(overhead prediction) + p_latency (format prediction) + c_latency
(conversion). f and c dominate and scale with the matrix; o and p are
constant-time model inferences. Auto-SpMV converts only when the predicted
gain over the remaining solver iterations exceeds the predicted overhead.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.features import SparsityFeatures, extract_features
from repro_torch.kernels.common import resolve_device
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
