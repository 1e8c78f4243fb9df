"""The port's predictor zoo (``repro_torch.ml``: centroid, SVM, boosting,
forests, MLP; ``model_zoo``; ``core.hpo.tune_model`` and
``core.predictor`` over every family) against the reference on the CPU.

Inputs come from seeded numpy generators. The numpy families are the
reference's code and must predict identically (the same seeds, the same
``np.random.default_rng`` streams). The MLP trains with PyTorch in the
port and with JAX in the reference: both get the same initial parameters
(the reference's He-normal draw, carried across as numpy) and are held to
1e-4 after scaling by max |reference| over 10 full-batch Adam steps; their
decisions are compared only where the reference's margin exceeds that
tolerance."""

import jax
import numpy as np
import pytest
import torch

from repro.core.dataset import collect_dataset as ref_collect
from repro.core.features import extract_features as ref_features
from repro.core.hpo import tune_model as ref_tune
from repro.core.predictor import AutoSpmvPredictor as RefPredictor
from repro.core.predictor import PredictorConfig as RefPredictorConfig
from repro.core.tuning_space import TuningConfig as RefTuningConfig
from repro.ml import mlp as ref_mlp
from repro.ml import model_zoo as ref_zoo
from repro.sparse.generate import MATRIX_NAMES, generate_by_name
from repro_torch import ml
from repro_torch.core.dataset import TuningDataset
from repro_torch.core.features import extract_features
from repro_torch.core.hpo import tune_model
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.tuning_space import TuningConfig
from repro_torch.ml import mlp
from repro_torch.ml import model_zoo as zoo
from repro_torch.ml.metrics import accuracy_score, r2_score
from repro_torch.sparse.registry import format_names

from torch_port_helpers import assert_scaled_close

MLP_TOL = 1e-4
NUMPY_CLASSIFIERS = ("nearest_centroid", "decision_tree", "svm", "gradient_boosting",
                     "random_forest")
NUMPY_REGRESSORS = ("bayesian_ridge", "lasso", "lars", "random_forest", "decision_tree")


def _blobs(n=90, k=3, d=4, spread=0.8, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, scale, (k, d))
    y = rng.integers(0, k, n)
    return centers[y] + rng.normal(0, spread, (n, d)), y


def _signal(n=80, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    return X, X @ rng.normal(size=d) + 0.3 * np.sin(3 * X[:, 0]) + rng.normal(0, 0.05, n)


@pytest.fixture
def same_mlp_init(monkeypatch):
    """The port's MLP starts from the reference's He-normal draw for the
    same seed (the generators draw different numbers)."""

    def init(generator, sizes, device):
        ref = ref_mlp._init_params(jax.random.PRNGKey(generator.initial_seed()), sizes)
        return [{k: torch.from_numpy(np.array(v)).to(device) for k, v in layer.items()}
                for layer in ref]

    monkeypatch.setattr(mlp, "_init_params", init)


# ----------------------------------------------------------------- the zoo
def test_zoo_names_spaces_and_defaults_equal_the_reference():
    for ours, theirs in ((zoo.CLASSIFIER_ZOO, ref_zoo.CLASSIFIER_ZOO),
                         (zoo.REGRESSOR_ZOO, ref_zoo.REGRESSOR_ZOO)):
        assert list(ours) == list(theirs)
        for name, entry in ours.items():
            assert entry["space"] == theirs[name]["space"], name
            assert entry["defaults"] == theirs[name]["defaults"], name
            assert entry["ctor"].__name__ == theirs[name]["ctor"].__name__
            assert entry["device"] == (name == "mlp")
    assert zoo.CLASSIFIER_NAMES == ref_zoo.CLASSIFIER_NAMES
    assert zoo.REGRESSOR_NAMES == ref_zoo.REGRESSOR_NAMES
    import repro.ml as ref_ml

    assert ml.__all__ == ref_ml.__all__


def test_make_passes_the_device_to_the_mlp_only():
    assert zoo.make_classifier("mlp", device="cpu").device == "cpu"
    assert zoo.make_regressor("mlp", hidden_layer_size=8).device is None
    assert not hasattr(zoo.make_classifier("svm", device="cpu"), "device")
    X, y = _blobs(n=12)
    with pytest.raises(RuntimeError, match="CUDA"):  # None = the card
        zoo.make_classifier("mlp", epochs=1).fit(X, y)


# ------------------------------------------------------ numpy families
CLASSIFIER_CASES = [
    ("nearest_centroid", dict(metric="manhattan")),
    ("nearest_centroid", dict(metric="euclidean")),
    ("nearest_centroid", dict(metric="minkowski")),
    ("svm", dict(kernel="linear")),
    ("svm", dict(kernel="poly", C=10.0)),
    ("svm", dict(kernel="rbf")),
    ("svm", dict(kernel="sigmoid", gamma="auto")),
    ("gradient_boosting", dict(n_estimators=20, learning_rate=0.1)),
    ("random_forest", dict(n_estimators=15, criterion="entropy")),
    ("random_forest", dict(n_estimators=15, criterion="log_loss", max_depth=None)),
]


@pytest.mark.parametrize("name,kw", CLASSIFIER_CASES, ids=lambda v: str(v))
def test_numpy_classifiers_predict_identically(name, kw):
    X, y = _blobs(seed=3)
    Xte, _ = _blobs(n=40, seed=4)
    ours = zoo.make_classifier(name, **kw).fit(X[:70], y[:70])
    theirs = ref_zoo.make_classifier(name, **kw).fit(X[:70], y[:70])
    np.testing.assert_array_equal(ours.predict(Xte), theirs.predict(Xte))
    for method in ("predict_proba", "decision_function"):
        if hasattr(theirs, method):
            np.testing.assert_array_equal(getattr(ours, method)(Xte),
                                          getattr(theirs, method)(Xte))
    assert ours.score(X[70:], y[70:]) == theirs.score(X[70:], y[70:])


@pytest.mark.parametrize("kw", [dict(n_estimators=12), dict(n_estimators=12, max_depth=4,
                                                              max_features="log2")])
def test_random_forest_regressor_predicts_identically(kw):
    X, y = _signal(seed=5)
    ours = zoo.make_regressor("random_forest", **kw).fit(X[:60], y[:60])
    theirs = ref_zoo.make_regressor("random_forest", **kw).fit(X[:60], y[:60])
    np.testing.assert_array_equal(ours.predict(X[60:]), theirs.predict(X[60:]))


# ----------------------------------------------------------------- the MLP
@pytest.mark.parametrize("act", sorted(mlp._ACTIVATIONS))
@pytest.mark.parametrize("loss_kind", ["xent", "mse"])
def test_mlp_train_matches_reference_from_the_same_init(act, loss_kind):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    X = rng.normal(size=(64, 5)).astype(np.float32)
    out_dim = 3 if loss_kind == "xent" else 1
    y = rng.integers(0, 3, 64) if loss_kind == "xent" else rng.normal(size=64).astype(np.float32)
    init = ref_mlp._init_params(jax.random.PRNGKey(2), [5, 16, 16, out_dim])
    ref_params, ref_losses = ref_mlp._train(
        init, jnp.asarray(X), jnp.asarray(y.astype(np.int32) if loss_kind == "xent" else y),
        act_name=act, loss_kind=loss_kind, epochs=10, lr=1e-2)
    port_init = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in init]
    params, losses = mlp._train(
        port_init, torch.from_numpy(X),
        torch.from_numpy(y.astype(np.int64) if loss_kind == "xent" else y),
        act_name=act, loss_kind=loss_kind, epochs=10, lr=1e-2)
    assert losses.shape == (10,)
    assert_scaled_close(losses.numpy(), np.asarray(ref_losses), MLP_TOL)
    for ours, theirs in zip(params, ref_params):
        for k in ("w", "b"):
            assert_scaled_close(ours[k].numpy(), np.asarray(theirs[k]), MLP_TOL)
    # the given parameters are left as they were
    assert all(torch.equal(port_init[i]["w"], torch.from_numpy(np.array(init[i]["w"])))
               for i in range(3))


def _margin_ok(scores: np.ndarray) -> np.ndarray:
    """Rows whose top two reference scores differ by more than the tolerance
    (after scaling): only there must the two packages decide alike."""
    top = np.sort(scores, axis=1)
    return (top[:, -1] - top[:, -2]) > 10 * MLP_TOL * (np.abs(scores).max() + 1e-9)


def test_mlp_estimators_match_reference_from_the_same_init(same_mlp_init):
    X, y = _blobs(n=80, seed=9)
    kw = dict(hidden_layer_size=24, n_layers=2, epochs=10, learning_rate=1e-2)
    ours = ml.MLPClassifier(**kw, device="cpu").fit(X, y)
    theirs = ref_mlp.MLPClassifier(**kw).fit(X, y)
    assert_scaled_close(ours.loss_curve_, np.asarray(theirs.loss_curve_), MLP_TOL)
    raw, ref_raw = ours._raw_predict(X), theirs._raw_predict(X)
    assert_scaled_close(raw, ref_raw, MLP_TOL)
    sure = _margin_ok(ref_raw)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ours.predict(X)[sure], theirs.predict(X)[sure])
    assert_scaled_close(ours.predict_proba(X), theirs.predict_proba(X), MLP_TOL)

    Xr, yr = _signal(seed=10)
    ours = ml.MLPRegressor(**kw, device="cpu").fit(Xr, yr)
    theirs = ref_mlp.MLPRegressor(**kw).fit(Xr, yr)
    assert_scaled_close(ours.loss_curve_, np.asarray(theirs.loss_curve_), MLP_TOL)
    assert_scaled_close(ours.predict(Xr), theirs.predict(Xr), MLP_TOL)


def test_mlp_learns_on_its_own_init():
    X, y = _blobs(n=120, spread=0.5, seed=1, scale=3.0)  # the reference test's blobs
    clf = ml.MLPClassifier(hidden_layer_size=32, n_layers=2, epochs=120, device="cpu")
    assert accuracy_score(y[90:], clf.fit(X[:90], y[:90]).predict(X[90:])) > 0.8
    assert clf.loss_curve_[-1] < clf.loss_curve_[0]
    again = ml.MLPClassifier(hidden_layer_size=32, n_layers=2, epochs=120, device="cpu")
    np.testing.assert_array_equal(again.fit(X[:90], y[:90]).loss_curve_, clf.loss_curve_)
    Xr, yr = _signal(n=120, seed=2)
    reg = ml.MLPRegressor(hidden_layer_size=32, n_layers=2, epochs=150, learning_rate=1e-2,
                          device="cpu")
    assert r2_score(yr[90:], reg.fit(Xr[:90], yr[:90]).predict(Xr[90:])) > 0.8


# ------------------------------------------------------------- tune_model
@pytest.mark.parametrize("kind,name", [("c", n) for n in NUMPY_CLASSIFIERS]
                         + [("r", n) for n in NUMPY_REGRESSORS])
def test_tune_model_picks_the_reference_parameters(kind, name):
    if kind == "c":
        X, y = _blobs(n=45, spread=1.5, seed=11)
        entry, ref_entry, metric = zoo.CLASSIFIER_ZOO[name], ref_zoo.CLASSIFIER_ZOO[name], \
            accuracy_score
    else:
        X, y = _signal(n=45, seed=12)
        entry, ref_entry, metric = zoo.REGRESSOR_ZOO[name], ref_zoo.REGRESSOR_ZOO[name], r2_score
    if name in ("gradient_boosting", "random_forest"):  # keep the trees few on the CPU
        entry = dict(entry, defaults=dict(entry["defaults"], n_estimators=8),
                     space={k: v for k, v in entry["space"].items() if k != "n_estimators"})
        ref_entry = dict(ref_entry, defaults=dict(ref_entry["defaults"], n_estimators=8),
                         space=entry["space"])
    ours = tune_model(entry, X, y, metric, n_trials=3, cv=3, seed=1, device="cpu")
    theirs = ref_tune(ref_entry, X, y, metric, n_trials=3, cv=3, seed=1)
    assert ours.best_params == theirs.best_params
    assert ours.best_value == theirs.best_value
    assert [t.params for t in ours.trials] == [t.params for t in theirs.trials]


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_tune_model_trains_the_mlp_on_the_given_device(kind, same_mlp_init):
    if kind == "classifier":
        X, y = _blobs(n=45, seed=13)
        entry, metric = zoo.CLASSIFIER_ZOO["mlp"], accuracy_score
    else:
        X, y = _signal(n=45, seed=14)
        entry, metric = zoo.REGRESSOR_ZOO["mlp"], r2_score
    entry = dict(entry, defaults=dict(entry["defaults"], epochs=5))
    res = tune_model(entry, X, y, metric, n_trials=2, cv=2, seed=0, device="cpu")
    assert res.n_trials == 2
    assert all(res.best_params[k] in v for k, v in entry["space"].items())
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_model(entry, X, y, metric, n_trials=1, cv=2, seed=0)


# ------------------------------------------------- predictors over the zoo
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The reference's dataset, and the same records loaded by the port."""
    ref = ref_collect(scale=0.0015, names=MATRIX_NAMES[:4], n_extra=2)
    path = tmp_path_factory.mktemp("zoo") / "ds.json"
    ref.save(path)
    return ref, TuningDataset.load(path)


def _held_out():
    return [generate_by_name(n, scale=0.002) for n in MATRIX_NAMES[8:11]]


# every classifier beside one regressor (one fit covers both); the random
# forest regressor on a small subsample
PAIRS = list(zip(zoo.CLASSIFIER_NAMES, ("bayesian_ridge", "lasso", "lars", "decision_tree",
                                        "random_forest", "mlp")))


@pytest.mark.parametrize("clf,reg", PAIRS)
def test_predictor_serves_both_modes_with_every_family(clf, reg, dataset, same_mlp_init):
    ref_ds, ds = dataset
    kw = dict(model_name=clf, regressor_name=reg, max_regressor_samples=60)
    ours = AutoSpmvPredictor(PredictorConfig(**kw, device="cpu")).fit(ds)
    held = _held_out()
    if "mlp" in (clf, reg):
        # another framework's float32 training: decisions are not compared
        # (margins unknown); the port's answers are well-formed
        for dense in held:
            f = extract_features(dense)
            for obj in ("latency", "energy"):
                assert ours.predict_format(f, obj) in format_names()
                s = ours.predict_schedule(f, obj)
                assert s.nnz_tile % s.unroll == 0
                est = ours.estimate_objective(f, TuningConfig("csr", s), obj)
                assert np.isfinite(est) and est > 0
        with pytest.raises(RuntimeError, match="CUDA"):
            AutoSpmvPredictor(PredictorConfig(**kw)).fit(ds)  # None = the card
        return
    ref = RefPredictor(RefPredictorConfig(**kw)).fit(ref_ds)
    for dense in held:
        fa, fb = extract_features(dense), ref_features(dense)
        for obj in ("latency", "energy", "power", "efficiency"):
            assert ours.predict_format(fa, obj) == ref.predict_format(fb, obj)
            sa, sb = ours.predict_schedule(fa, obj), ref.predict_schedule(fb, obj)
            assert sa.as_dict() == sb.as_dict()
            a = ours.estimate_objective(fa, TuningConfig("ell", sa), obj)
            b = ref.estimate_objective(fb, RefTuningConfig("ell", sb), obj)
            assert a == pytest.approx(b, rel=1e-9)


@pytest.mark.parametrize("clf", ["nearest_centroid", "svm"])
def test_predictor_tunes_its_classifiers_like_the_reference(clf, dataset):
    ref_ds, ds = dataset
    kw = dict(model_name=clf, tune=True, n_trials=3, max_regressor_samples=100)
    ours = AutoSpmvPredictor(PredictorConfig(**kw, device="cpu")).fit(ds)
    ref = RefPredictor(RefPredictorConfig(**kw)).fit(ref_ds)
    for obj in ("latency", "efficiency"):
        a, b = ours.format_clf_[obj], ref.format_clf_[obj]
        assert type(a).__name__ == type(b).__name__
        assert vars(a).get("metric", vars(a).get("kernel")) == vars(b).get(
            "metric", vars(b).get("kernel"))
    for dense in _held_out()[:2]:
        fa, fb = extract_features(dense), ref_features(dense)
        assert ours.predict_format(fa, "latency") == ref.predict_format(fb, "latency")
        assert (ours.predict_schedule(fa, "latency").as_dict()
                == ref.predict_schedule(fb, "latency").as_dict())
