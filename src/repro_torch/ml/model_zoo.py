"""Model registry + hyperparameter search spaces (paper Tables 1 and 4).

``CLASSIFIER_ZOO`` / ``REGRESSOR_ZOO`` map model names to (constructor,
search-space) pairs consumed by ``repro_torch.core.hpo``. The search spaces
are the paper's Table 1 ranges verbatim; defaults are the paper's tuned
Table 4 settings so un-tuned runs reproduce the reported models.

Only the families ported so far are registered, under the reference
package's entry names: the decision trees (the paper's winners, and what the
predictors use by default) and the linear regressors. Nearest centroid, SVM,
gradient boosting, random forest and MLP follow in a later slice.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.ml.linear import BayesianRidge, Lars, Lasso
from repro_torch.ml.tree import DecisionTreeClassifier, DecisionTreeRegressor

SearchSpace = dict[str, list[Any]]


def _zoo_entry(ctor: Callable, space: SearchSpace, defaults: dict) -> dict:
    return {"ctor": ctor, "space": space, "defaults": defaults}


CLASSIFIER_ZOO: dict[str, dict] = {
    # Table 1 spaces; Table 4 tuned defaults
    "decision_tree": _zoo_entry(
        DecisionTreeClassifier,
        {
            "criterion": ["gini", "entropy", "log_loss"],
            "splitter": ["best", "random"],
            "max_depth": [5, 9, 13, 15, None],
        },
        {"criterion": "gini", "splitter": "best", "max_depth": 13},
    ),
}

REGRESSOR_ZOO: dict[str, dict] = {
    "bayesian_ridge": _zoo_entry(
        BayesianRidge, {"n_iter": [100, 300], "tol": [1e-3, 1e-4]}, {"n_iter": 300, "tol": 1e-3}
    ),
    "lasso": _zoo_entry(
        Lasso, {"alpha": [0.001, 0.01, 0.1, 1.0]}, {"alpha": 1.0, "n_iter": 1000}
    ),
    "lars": _zoo_entry(Lars, {"n_nonzero_coefs": [8, 64, 500]}, {"n_nonzero_coefs": 500}),
    "decision_tree": _zoo_entry(
        DecisionTreeRegressor, {"max_depth": [5, 10, None]}, {"max_depth": None}
    ),
}

CLASSIFIER_NAMES = tuple(CLASSIFIER_ZOO)
REGRESSOR_NAMES = tuple(REGRESSOR_ZOO)


def make_classifier(name: str, **overrides):
    entry = CLASSIFIER_ZOO[name]
    kw = dict(entry["defaults"])
    kw.update(overrides)
    return entry["ctor"](**kw)


def make_regressor(name: str, **overrides):
    entry = REGRESSOR_ZOO[name]
    kw = dict(entry["defaults"])
    kw.update(overrides)
    return entry["ctor"](**kw)
