"""Hyperparameter optimization — the AutoML stage (paper §5.4).

The paper uses Optuna with Bayesian (TPE) search. Optuna is unavailable
offline, so this module implements the same semantics from scratch:

* ``random_search`` — uniform sampling over the discrete space;
* ``tpe_search`` — Tree-structured Parzen Estimator over discrete choices:
  after a random warmup, candidates are scored by the ratio l(x)/g(x) of
  smoothed categorical densities fit to the best gamma-quantile trials (l)
  vs the rest (g), and the best-EI candidate is evaluated next. This is the
  standard TPE algorithm restricted to categorical dimensions — which is
  exactly the paper's Table 1 space (all choices are discrete).

``tune_model`` wires either search to a (model-zoo entry, dataset,
metric) triple with k-fold cross-validation on the training split.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.ml.model_zoo import build

SearchSpace = dict[str, list[Any]]
Objective = Callable[[dict[str, Any]], float]  # larger is better


@dataclass
class Trial:
    params: dict[str, Any]
    value: float


@dataclass
class StudyResult:
    best_params: dict[str, Any]
    best_value: float
    trials: list[Trial] = field(default_factory=list)

    @property
    def n_trials(self) -> int:
        return len(self.trials)


def _space_size(space: SearchSpace) -> int:
    return int(np.prod([len(v) for v in space.values()])) if space else 1


def _sample(space: SearchSpace, rng) -> dict[str, Any]:
    return {k: v[rng.integers(0, len(v))] for k, v in space.items()}


def grid_iter(space: SearchSpace):
    keys = list(space)
    for combo in itertools.product(*(space[k] for k in keys)):
        yield dict(zip(keys, combo))


def random_search(objective: Objective, space: SearchSpace, n_trials: int = 20,
                  seed: int = 0) -> StudyResult:
    rng = np.random.default_rng(seed)
    trials: list[Trial] = []
    seen: set[tuple] = set()
    budget = min(n_trials, _space_size(space))
    while len(trials) < budget:
        params = _sample(space, rng)
        key = tuple(sorted((k, str(v)) for k, v in params.items()))
        if key in seen and len(seen) < _space_size(space):
            continue
        seen.add(key)
        trials.append(Trial(params, float(objective(params))))
    best = max(trials, key=lambda t: t.value)
    return StudyResult(best.params, best.value, trials)


def tpe_search(objective: Objective, space: SearchSpace, n_trials: int = 30,
               n_warmup: int = 8, gamma: float = 0.25, n_candidates: int = 24,
               seed: int = 0) -> StudyResult:
    """Categorical TPE (Bergstra et al. 2011), maximizing ``objective``."""
    rng = np.random.default_rng(seed)
    trials: list[Trial] = []
    budget = min(n_trials, _space_size(space))

    def density(values: list[Any], choices: list[Any]) -> np.ndarray:
        # Laplace-smoothed categorical density over `choices`
        counts = np.ones(len(choices))  # prior
        index = {str(c): i for i, c in enumerate(choices)}
        for v in values:
            counts[index[str(v)]] += 1.0
        return counts / counts.sum()

    while len(trials) < budget:
        if len(trials) < n_warmup:
            params = _sample(space, rng)
        else:
            order = sorted(trials, key=lambda t: -t.value)
            n_good = max(1, int(math.ceil(gamma * len(order))))
            good, bad = order[:n_good], order[n_good:] or order[n_good - 1 :]
            # per-dimension densities
            l_d = {k: density([t.params[k] for t in good], space[k]) for k in space}
            g_d = {k: density([t.params[k] for t in bad], space[k]) for k in space}
            best_params, best_score = None, -np.inf
            for _ in range(n_candidates):
                cand = {}
                for k, choices in space.items():
                    cand[k] = choices[rng.choice(len(choices), p=l_d[k])]
                score = sum(
                    math.log(l_d[k][[str(c) for c in space[k]].index(str(cand[k]))])
                    - math.log(g_d[k][[str(c) for c in space[k]].index(str(cand[k]))])
                    for k in space
                )
                if score > best_score:
                    best_params, best_score = cand, score
            params = best_params
        trials.append(Trial(params, float(objective(params))))
    best = max(trials, key=lambda t: t.value)
    return StudyResult(best.params, best.value, trials)


# ---------------------------------------------------------------------------
# model-zoo integration
# ---------------------------------------------------------------------------


def kfold_indices(n: int, k: int, seed: int = 0):
    idx = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(idx, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val


def tune_model(
    zoo_entry: dict,
    X: np.ndarray,
    y: np.ndarray,
    metric: Callable[[np.ndarray, np.ndarray], float],
    *,
    n_trials: int = 20,
    cv: int = 3,
    method: str = "tpe",
    seed: int = 0,
    device=None,
) -> StudyResult:
    """Cross-validated HPO of one zoo model; returns the study result.

    ``metric(y_true, y_pred) -> float`` (larger better). The tuned params
    are merged over the zoo defaults, mirroring how Optuna-tuned values
    override scikit-learn defaults in the paper (§6.4). ``device`` goes to
    the families that train on one (the MLPs; ``None`` = the card).
    """
    X, y = np.asarray(X), np.asarray(y)
    n = X.shape[0]
    cv = max(2, min(cv, n))

    def objective(params: dict[str, Any]) -> float:
        scores = []
        for tr, va in kfold_indices(n, cv, seed=seed):
            model = build(zoo_entry, device, **params)
            model.fit(X[tr], y[tr])
            scores.append(metric(y[va], model.predict(X[va])))
        return float(np.mean(scores))

    search = tpe_search if method == "tpe" else random_search
    return search(objective, zoo_entry["space"], n_trials=n_trials, seed=seed)
