"""The card tuner's served path, on the CPU: ``build_tuner`` labelled by the
card's cost model learns at the size the card serves, and gates
conversions with the card's §5.3 predictor.

With ``CardCostModel`` the dataset holds each training matrix twice: at the
tuner's ``scale`` (as before) and at ``SERVED_ROWS`` rows (records of
``"<name>@<rows>"``, labelled from the matrix's statistics: no conversion,
no timing). The reference-equal path (``CostModel``) gets no served-size
records and stays the reference's. ``CardOverheadPredictor`` fits a fixed
cost plus the dense scan (n^2) plus the nonzeros per format, non-negative
(positive, rising, exact on samples of an exact law of that form);
``OverheadPredictor`` stays the reference's ridge."""

import dataclasses

import numpy as np
import pytest

from repro.core import OverheadPredictor as RefOverhead
from repro.core import OverheadSample as RefSample
from repro.core import SparsityFeatures as RefFeatures
from repro.core import collect_dataset as ref_collect
from repro_torch.core import session
from repro_torch.core.features import SparsityFeatures
from repro_torch.core.objectives import CardCostModel, CostModel
from repro_torch.core.overhead import (
    CardOverheadPredictor,
    OverheadPredictor,
    OverheadSample,
    measure_served_overheads,
)
from repro_torch.core.session import SERVED_ROWS, build_tuner, served_matrix
from repro_torch.kernels import ops
from repro_torch.sparse import formats
from repro_torch.sparse.generate import MATRIX_NAMES, SUITE, random_matrix
from repro_torch.sparse.registry import format_names

from torch_port_helpers import reference_profile

NAMES = MATRIX_NAMES[:2]
SCALE = 0.0015


def _features(n, nnz):
    return SparsityFeatures(n=float(n), nnz=float(nnz), avg_nnz=nnz / n, var_nnz=1.0,
                            ell_ratio=0.5, median=nnz / n, mode=nnz / n, std_nnz=1.0)


def _law(n, nnz, fmt_scale=1.0):
    return fmt_scale * (2e-4 + 1.5e-9 * n * n + 7e-8 * nnz)


def _scale_records(model):
    from repro_torch.core.dataset import collect_dataset

    return collect_dataset(scale=SCALE, names=NAMES, n_extra=0, model=model).records


def _key(r):
    """A record as comparable values (NaN labels compare equal)."""
    d = dataclasses.asdict(r)
    d["config"] = r.config.as_dict()
    d["features"] = r.features.dict()
    return {k: ("nan" if isinstance(v, float) and np.isnan(v) else v) for k, v in d.items()}


# ------------------------------------------------ served-size records
def test_card_tuner_holds_each_name_at_the_served_size_too():
    assert SERVED_ROWS == 14_000
    tuner = build_tuner(names=NAMES, n_extra=0, fit_overhead=False, device="cpu",
                        model=CardCostModel())
    ds = tuner.dataset
    served = [f"{n}@{served_matrix(n).shape[0]}" for n in NAMES]
    assert ds.meta["served"] == {"rows": SERVED_ROWS, "matrices": served}
    assert served == ["shar_te2-b3@14000", "rim@13999"]
    assert ds.matrices == [*NAMES, *served]
    assert ds.meta["n_matrices"] == 4
    scale_only = _scale_records(CardCostModel())
    per_matrix = len(scale_only) // len(NAMES)
    for name, at in zip(NAMES, served):
        rows = ds.for_matrix(at)
        assert len(rows) == per_matrix  # the whole space, as at scale
        assert {r.source for r in rows} == {"model_h100_card"}
        assert {r.features.n for r in rows} == {float(served_matrix(name).shape[0])}
        assert abs(rows[0].features.n - SERVED_ROWS) <= 1
        # only the served records are at that size
        assert all(r.features.n < 1000 for r in ds.for_matrix(name))
    # the records at scale are the ones collect_dataset gives, unchanged
    assert [_key(r) for r in ds.records[:len(scale_only)]] == [_key(r) for r in scale_only]


def test_served_records_come_from_statistics_alone_and_once_per_process(monkeypatch):
    monkeypatch.setattr(session, "SERVED_ROWS", 700)  # a size no other test asks for
    calls = {"generated": 0, "converted": 0}
    real_matrix = session.served_matrix

    def counted(name):
        calls["generated"] += 1
        return real_matrix(name)

    monkeypatch.setattr(session, "served_matrix", counted)
    for mod, fn in ((formats, "from_dense"), (ops, "prepare")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _real=real, **k: (
            calls.__setitem__("converted", calls["converted"] + 1), _real(*a, **k))[1])
    first = build_tuner(names=NAMES, n_extra=0, fit_overhead=False, device="cpu",
                        model=CardCostModel())
    assert calls == {"generated": 2, "converted": 0}
    assert [abs(first.dataset.for_matrix(m)[0].features.n - 700) <= 1
            for m in first.dataset.meta["served"]["matrices"]] == [True, True]
    again = build_tuner(names=NAMES, n_extra=0, fit_overhead=False, device="cpu",
                        model=CardCostModel())
    assert calls["generated"] == 2  # the second tuner reads the memo
    assert [_key(r) for r in again.dataset.records] == [_key(r) for r in first.dataset.records]
    assert again.dataset.records[-1] is not first.dataset.records[-1]  # copies


def test_the_reference_equal_tuner_keeps_the_references_dataset():
    tuner = build_tuner(names=NAMES, n_extra=0, fit_overhead=False, device="cpu",
                        model=CostModel(reference_profile()))
    assert "served" not in tuner.dataset.meta
    ref = ref_collect(scale=SCALE, names=NAMES, n_extra=0)
    assert tuner.dataset.matrices == list(NAMES)
    assert [_key(r) for r in tuner.dataset.records] == [_key(r) for r in ref.records]
    assert type(build_tuner(names=NAMES[:1], n_extra=0, device="cpu").overhead) \
        is OverheadPredictor


def test_card_tuner_gates_with_the_card_predictor_and_served_samples(monkeypatch):
    monkeypatch.setattr(session, "SERVED_ROWS", 640)
    seen = []
    real = session._served_overhead
    monkeypatch.setattr(session, "_served_overhead",
                        lambda name, *a: seen.append(name) or real(name, *a))
    names = MATRIX_NAMES[:4]
    tuner = build_tuner(names=names, n_extra=0, device="cpu", model=CardCostModel())
    assert type(tuner.overhead) is CardOverheadPredictor
    assert seen == list(names[:session.SERVED_OVERHEAD_MATRICES])
    feats = tuner.dataset.for_matrix(tuner.dataset.meta["served"]["matrices"][0])[0].features
    for fmt in format_names():
        assert tuner.overhead.predict_c(feats, fmt) > 0.0
    assert tuner.overhead.total_overhead(feats, "ell") > tuner.overhead.predict_c(feats, "ell")


def test_served_overheads_skip_what_the_storage_guard_refuses(monkeypatch):
    from repro_torch.sparse import registry as reg

    dense = random_matrix(600, 40.0, "fem", seed=1).astype(np.float32)
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 600 * 128 * 8 - 1)  # no ELL plane of 128
    s = measure_served_overheads(dense, "rim@600", device="cpu")
    assert s.features.n == 600 and s.f_latency > 0
    assert "csr" in s.c_latency and "ell" not in s.c_latency
    assert all(t > 0 for t in s.c_latency.values())


# ------------------------------------------------ CardOverheadPredictor
def test_card_predictor_recovers_an_exact_law_of_its_form():
    rng = np.random.default_rng(0)
    sizes = [(int(n), int(n * a)) for n, a in zip(rng.integers(40, 20_000, 12),
                                                     rng.uniform(2, 60, 12))]
    samples = [OverheadSample(f"m{i}", _features(n, z), _law(n, z, 0.3),
                              {"csr": _law(n, z), "ell": _law(n, z, 2.0)})
               for i, (n, z) in enumerate(sizes)]
    pred = CardOverheadPredictor().fit(samples)
    for n, z in [(14_340, 8_813_632), (64, 200), (3_000, 90_000)]:
        f = _features(n, z)
        assert pred.predict_c(f, "csr") == pytest.approx(_law(n, z), rel=1e-9)
        assert pred.predict_c(f, "ell") == pytest.approx(_law(n, z, 2.0), rel=1e-9)
        assert pred.predict_f(f) == pytest.approx(_law(n, z, 0.3), rel=1e-9)
        # a format no sample measured: the dearest prediction, as the reference
        assert pred.predict_c(f, "bcsr") == pred.predict_c(f, "ell")


# The §5.3 samples of the pool at n ~ 14,000 (features; feature pass and
# default-geometry conversions in seconds), from chip_smoke.py's phase 17(b)
# on an NVIDIA H100 80GB HBM3 at 700 W
POOL_SAMPLES = {
    "human_gene2": ((14340, 8813632, 614.6187, 32891.9764, 0.4523, 616, 576, 181.3615), 0.279,
                    {"csr": 0.925, "ell": 2.232, "sell": 1.467}),
    "rim": ((13999, 539389, 38.5305, 7.8556, 0.8027, 39, 38, 2.8028), 0.276,
            {"csr": 0.31, "ell": 0.717, "sell": 0.405}),
    "bcsstk32": ((14000, 275537, 19.6812, 2.8779, 0.7872, 20, 20, 1.6964), 0.289,
                 {"csr": 0.396, "ell": 0.722, "sell": 0.407}),
    "viscorocks": ((14000, 368840, 26.3457, 4.4608, 0.7527, 26, 26, 2.1121), 0.297,
                   {"csr": 0.5, "ell": 0.95, "sell": 0.369}),
    "pkustk04": ((14000, 559552, 39.968, 0.255, 0.9992, 40, 40, 0.505), 0.343,
                 {"csr": 0.405, "ell": 0.768, "sell": 0.461}),
}


def test_card_predictor_left_out_calls_no_conversion_free():
    samples = {m: OverheadSample(m, SparsityFeatures(*map(float, v)), f, c)
               for m, (v, f, c) in POOL_SAMPLES.items()}
    for m, s in samples.items():
        held = [t for t in samples.values() if t is not s]
        card, ref = CardOverheadPredictor().fit(held), OverheadPredictor().fit(held)
        for fmt, measured in s.c_latency.items():
            assert 0.25 <= card.predict_c(s.features, fmt) / measured <= 4.0, (m, fmt)
        assert 0.25 <= card.predict_f(s.features) / s.f_latency <= 4.0
    # the reference's ridge, the largest matrix left out: SELL free, CSR 100 x
    hg2 = samples["human_gene2"]
    ref = OverheadPredictor().fit([t for t in samples.values() if t is not hg2])
    assert ref.predict_c(hg2.features, "sell") == 0.0
    assert ref.predict_c(hg2.features, "csr") > 40 * hg2.c_latency["csr"]


def test_card_predictor_is_positive_and_rises_with_the_matrix():
    samples = [OverheadSample(m, SparsityFeatures(*map(float, v)), f, c)
               for m, (v, f, c) in POOL_SAMPLES.items()]
    pred = CardOverheadPredictor().fit(samples)
    for fmt in ("csr", "ell", "sell"):
        assert pred.predict_c(_features(30, 90), fmt) > 0.0
        by_nnz = [pred.predict_c(_features(14_000, z), fmt) for z in (1e4, 1e5, 1e6, 1e7)]
        assert by_nnz == sorted(by_nnz) and by_nnz[0] < by_nnz[-1]


def test_card_predictor_fits_each_format_on_the_samples_that_measured_it():
    samples = [OverheadSample("a", _features(14_000, 50_000), 0.3, {"csr": 0.4}),
               OverheadSample("b", _features(14_000, 500_000), 0.3,
                              {"csr": 0.5, "ell": 0.8, "sell": 0.45}),
               OverheadSample("c", _features(300, 3_000), 1e-4,
                              {"csr": 1e-3, "ell": 2e-3, "sell": 1e-3})]
    pred = CardOverheadPredictor().fit(samples)
    assert sorted(pred._c_models) == ["csr", "ell", "sell"]
    f = _features(14_000, 500_000)
    assert pred.predict_c(f, "ell") == pytest.approx(0.8, rel=1e-9)  # two samples: exact
    # OverheadPredictor learns only the formats every sample has
    assert sorted(OverheadPredictor().fit(samples)._c_models) == ["csr"]


# ------------------------------------------------ the reference's predictor
def test_overhead_predictor_predicts_the_references_numbers():
    rng = np.random.default_rng(3)
    port, ref = [], []
    for i in range(7):
        n = int(rng.integers(50, 20_000))
        vals = dict(n=float(n), nnz=float(n * rng.uniform(2, 50)), avg_nnz=rng.uniform(2, 50),
                    var_nnz=rng.uniform(0, 9), ell_ratio=rng.uniform(0.1, 1), median=3.0,
                    mode=2.0, std_nnz=rng.uniform(0, 3))
        c = {f: float(rng.uniform(1e-4, 2.0)) for f in ("csr", "ell", "sell", "bell")}
        f_lat = float(rng.uniform(1e-4, 0.4))
        port.append(OverheadSample(f"m{i}", SparsityFeatures(**vals), f_lat, c))
        ref.append(RefSample(f"m{i}", RefFeatures(**vals), f_lat, c))
    ours, theirs = OverheadPredictor().fit(port), RefOverhead().fit(ref)
    for p, r in zip(port, ref):
        assert ours.predict_f(p.features) == theirs.predict_f(r.features)
        for fmt in ("csr", "ell", "sell", "bell", "bcsr"):
            assert ours.predict_c(p.features, fmt) == theirs.predict_c(r.features, fmt)
            assert ours.total_overhead(p.features, fmt) == theirs.total_overhead(r.features, fmt)


def test_served_matrix_is_the_pool_cut():
    for name in ("rim", "pkustk04", "shar_te2-b3"):
        n = served_matrix(name).shape[0]
        assert n == int(SUITE[name].n * min(1.0, SERVED_ROWS / SUITE[name].n))
