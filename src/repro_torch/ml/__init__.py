"""From-scratch ML substrate (scikit-learn is not available offline).

Holds the model families ported so far: decision trees for classification
and regression (the paper's winners, Tables 4 and 5) and the linear
regressors (Bayesian ridge, lasso, LARS, ridge). The remaining families of
the paper's Tables 1 and 4 follow in a later slice.
"""

from repro_torch.ml.base import StandardScaler, train_test_split
from repro_torch.ml.tree import DecisionTreeClassifier, DecisionTreeRegressor
from repro_torch.ml.linear import BayesianRidge, Lars, Lasso, Ridge
from repro_torch.ml.metrics import (
    accuracy_score,
    confusion_matrix,
    f1_score,
    mean_squared_error,
    r2_score,
)
from repro_torch.ml.model_zoo import (
    CLASSIFIER_ZOO,
    REGRESSOR_ZOO,
    make_classifier,
    make_regressor,
)

__all__ = [
    "StandardScaler",
    "train_test_split",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "BayesianRidge",
    "Lars",
    "Lasso",
    "Ridge",
    "accuracy_score",
    "confusion_matrix",
    "f1_score",
    "mean_squared_error",
    "r2_score",
    "CLASSIFIER_ZOO",
    "REGRESSOR_ZOO",
    "make_classifier",
    "make_regressor",
]
