"""From-scratch ML substrate (scikit-learn is not available offline).

Implements exactly the model families the paper fine-tunes (Tables 1 and 4):
nearest centroid, decision tree, non-linear SVM, gradient boosting, random
forest and MLP for classification; Bayesian ridge, lasso, LARS, random
forest, decision tree and MLP for regression — with the hyperparameters the
paper searches over. The numpy families are the reference's code; the MLP
trains with PyTorch on a device (``device=``, ``None`` = the card).
"""

from repro_torch.ml.base import StandardScaler, train_test_split
from repro_torch.ml.centroid import NearestCentroid
from repro_torch.ml.tree import DecisionTreeClassifier, DecisionTreeRegressor
from repro_torch.ml.forest import RandomForestClassifier, RandomForestRegressor
from repro_torch.ml.boosting import GradientBoostingClassifier
from repro_torch.ml.svm import NonlinearSVM
from repro_torch.ml.mlp import MLPClassifier, MLPRegressor
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
    "NearestCentroid",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "GradientBoostingClassifier",
    "NonlinearSVM",
    "MLPClassifier",
    "MLPRegressor",
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
