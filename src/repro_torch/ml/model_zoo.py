"""Model registry + hyperparameter search spaces (paper Tables 1 and 4).

``CLASSIFIER_ZOO`` / ``REGRESSOR_ZOO`` map model names to (constructor,
search-space) pairs consumed by ``repro_torch.core.hpo``. The search spaces
are the paper's Table 1 ranges verbatim; defaults are the paper's tuned
Table 4 settings so un-tuned runs reproduce the reported models.

Every family the paper fine-tunes is registered, under the reference
package's names. The MLPs train on a device: their entries carry
``"device": True`` and ``build`` (as ``make_classifier`` /
``make_regressor``, ``core.hpo.tune_model`` and ``core.predictor``) passes
the caller's ``device`` to them (``None`` = the card, raising where there
is none); the numpy families take none.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.ml.boosting import GradientBoostingClassifier
from repro_torch.ml.centroid import NearestCentroid
from repro_torch.ml.forest import RandomForestClassifier, RandomForestRegressor
from repro_torch.ml.linear import BayesianRidge, Lars, Lasso
from repro_torch.ml.mlp import MLPClassifier, MLPRegressor
from repro_torch.ml.svm import NonlinearSVM
from repro_torch.ml.tree import DecisionTreeClassifier, DecisionTreeRegressor

SearchSpace = dict[str, list[Any]]


def _zoo_entry(ctor: Callable, space: SearchSpace, defaults: dict,
               device: bool = False) -> dict:
    return {"ctor": ctor, "space": space, "defaults": defaults, "device": device}


def build(entry: dict, device=None, **overrides):
    """One estimator of a zoo entry: its defaults under ``overrides``, and
    ``device`` where the family trains on one."""
    kw = dict(entry["defaults"])
    kw.update(overrides)
    if entry.get("device"):
        kw["device"] = device
    return entry["ctor"](**kw)


CLASSIFIER_ZOO: dict[str, dict] = {
    # Table 1 spaces; Table 4 tuned defaults
    "nearest_centroid": _zoo_entry(
        NearestCentroid,
        {"metric": ["manhattan", "euclidean", "minkowski"]},
        {"metric": "manhattan"},
    ),
    "decision_tree": _zoo_entry(
        DecisionTreeClassifier,
        {
            "criterion": ["gini", "entropy", "log_loss"],
            "splitter": ["best", "random"],
            "max_depth": [5, 9, 13, 15, None],
        },
        {"criterion": "gini", "splitter": "best", "max_depth": 13},
    ),
    "svm": _zoo_entry(
        NonlinearSVM,
        {"kernel": ["linear", "poly", "rbf", "sigmoid"], "C": [0.1, 1.0, 10.0]},
        {"kernel": "rbf", "C": 1.0, "degree": 3, "gamma": "scale"},
    ),
    "gradient_boosting": _zoo_entry(
        GradientBoostingClassifier,
        {
            "n_estimators": [50, 100, 150, 200],
            "learning_rate": [0.1, 0.01, 0.001],
        },
        {"n_estimators": 100, "learning_rate": 0.1},
    ),
    "random_forest": _zoo_entry(
        RandomForestClassifier,
        {"criterion": ["gini", "entropy", "log_loss"], "max_depth": [10, 15, None]},
        {"criterion": "gini", "n_estimators": 100, "max_depth": 15},
    ),
    "mlp": _zoo_entry(
        MLPClassifier,
        {
            "hidden_layer_size": [20, 50, 100, 150, 200],
            "n_layers": [1, 2, 3, 4, 5, 10],
            "activation": ["identity", "logistic", "tanh", "relu"],
        },
        {
            "hidden_layer_size": 100,
            "n_layers": 5,
            "activation": "relu",
            "epochs": 200,
            "learning_rate": 1e-3,
        },
        device=True,
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
    "random_forest": _zoo_entry(
        RandomForestRegressor,
        {"n_estimators": [50, 100], "max_depth": [10, None]},
        {"n_estimators": 100, "max_depth": None},
    ),
    "decision_tree": _zoo_entry(
        DecisionTreeRegressor, {"max_depth": [5, 10, None]}, {"max_depth": None}
    ),
    "mlp": _zoo_entry(
        MLPRegressor,
        {
            "hidden_layer_size": [50, 100, 200],
            "n_layers": [2, 3, 5],
            "activation": ["relu", "tanh"],
        },
        {
            "hidden_layer_size": 200,
            "n_layers": 5,
            "activation": "relu",
            "epochs": 200,
            "learning_rate": 1e-4,
        },
        device=True,
    ),
}

CLASSIFIER_NAMES = tuple(CLASSIFIER_ZOO)
REGRESSOR_NAMES = tuple(REGRESSOR_ZOO)


def make_classifier(name: str, device=None, **overrides):
    return build(CLASSIFIER_ZOO[name], device, **overrides)


def make_regressor(name: str, device=None, **overrides):
    return build(REGRESSOR_ZOO[name], device, **overrides)
