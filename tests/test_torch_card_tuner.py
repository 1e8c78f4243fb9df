"""The tuner on the card: its space, its measured dataset and the labels a
predictor learns from it, on the CPU.

The card's space (``CardSpace``) is computed from integers (the matrix's
shape and row counts, the launch plans, the SM count): no tensor, no
device. The reference-equal knobs, choice sets and spaces stay the
reference's. ``collect_dataset(measure=True)`` over the card's space runs
here with a scripted timer in place of CUDA events (the CPU has none), and
``AutoSpmvPredictor.fit`` is held to the reference's on a dataset of model
records alone."""

import math

import numpy as np
import pytest

from repro.core import tuning_space as ref_space
from repro.core.dataset import TuningDataset as RefDataset
from repro.core.features import extract_features as ref_features
from repro.core.predictor import AutoSpmvPredictor as RefPredictor
from repro.core.predictor import PredictorConfig as RefPredictorConfig
from repro.kernels import common as ref_common
from repro.sparse.generate import random_matrix
from repro_torch.core import tuning_space as space
from repro_torch.core.dataset import TuningDataset, TuningRecord, collect_dataset, is_measured
from repro_torch.core.features import extract_features
from repro_torch.core.objectives import OBJECTIVES
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.tuning_space import CardSpace, TuningConfig, card_compile_time_space
from repro_torch.kernels import common
from repro_torch.kernels import ops
from repro_torch.kernels.common import DEFAULT_SCHEDULE, InfeasibleConfig, KernelSchedule
from repro_torch.sparse import formats
from repro_torch.sparse import registry as reg

from torch_port_helpers import FORMATS, with_bcsr  # noqa: F401  (fixture)

CASES = [(160, 9.0, "fem"), (210, 14.0, "powerlaw"), (96, 20.0, "block"), (150, 5.0, "banded")]


def _dense(i):
    n, avg, pattern = CASES[i]
    return random_matrix(n, avg, pattern, seed=10 + i).astype(np.float32)


# ------------------------------------------------- (i) the card's space
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("n_sms", [132, 16])
def test_card_points_are_distinct_launches(case, n_sms):
    stats = reg.MatrixStats(_dense(case))
    card = CardSpace(n_sms=n_sms)
    points = card.points(stats)
    keys = [(p.fmt, *card.launch(stats, p)[:2]) for p in points]
    assert len(set(keys)) == len(keys) == len(points)
    assert {p.fmt for p in points} == set(FORMATS)
    reference = set(space.full_space())
    assert all(p in reference for p in points)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_every_reference_point_maps_to_one_card_point_with_its_launch(case):
    stats = reg.MatrixStats(_dense(case))
    card = CardSpace()
    points = card.points(stats)
    by_key = {}
    for p in points:
        by_key.setdefault((p.fmt, *card.launch(stats, p)[:2]), []).append(p)
    for i, cfg in enumerate(space.full_space()):
        at = card.launch(stats, cfg)
        owners = by_key[(cfg.fmt, at.geometry, at.launch)]
        assert len(owners) == 1 and card.launch(stats, owners[0]) == at
        if i % 61 == 0:  # point_of groups the whole space per call
            assert card.point_of(stats, cfg) == owners[0]


def test_csr_card_space_holds_the_knobs_b1_reads():
    stats = reg.MatrixStats(_dense(1))
    csr = card_compile_time_space().points(stats)
    n = len(common.ROWS_PER_BLOCK_CHOICES) * len(common.UNROLL_CHOICES) * 2 * 2
    assert len(csr) == n == 112
    assert {p.schedule.nnz_tile for p in csr} == {DEFAULT_SCHEDULE.nnz_tile}
    assert {p.schedule.x_residency for p in csr} == set(common.X_RESIDENCY_CHOICES)
    assert {p.schedule.accum_dtype for p in csr} == set(common.ACCUM_DTYPE_CHOICES)
    # the default is its own point; nnz_tile reaches no CSR launch
    assert card_compile_time_space().point_of(stats, space.TuningConfig("csr", DEFAULT_SCHEDULE)) == (
        space.TuningConfig("csr", DEFAULT_SCHEDULE))
    wide = space.TuningConfig("csr", KernelSchedule(rows_per_block=16, nnz_tile=1024, unroll=8))
    assert card_compile_time_space().point_of(stats, wide).schedule == wide.schedule.replace(
        nnz_tile=128)
    assert set(space.CARD_KNOBS) <= set(space.KNOBS) and "nnz_tile" not in space.CARD_KNOBS


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", [0, 2])
def test_card_geometry_is_what_prepare_builds(fmt, case):
    dense = _dense(case)
    stats = reg.MatrixStats(dense)
    card = CardSpace()
    for pt in card.points(stats):
        if pt.fmt != fmt or pt.schedule.accum_dtype != "float32" or pt.schedule.unroll != 1:
            continue
        at = card.launch(stats, pt)
        mat = ops.prepare(dense, fmt, pt.schedule, device="cpu")
        if fmt == "csr":
            assert at.geometry == (*mat.shape, mat.nnz)
        elif fmt == "ell":
            assert at.geometry == tuple(mat.data.shape)
        elif fmt == "sell":
            assert at.geometry == (mat.C, mat.data.shape[0], int(mat.slice_width.max()))
        else:
            nbr, mb, br, _ = mat.data.shape
            assert at.geometry == (br, nbr, mb)
        assert at.feasible


def test_card_feasibility_is_the_storage_guard(monkeypatch):
    dense = _dense(0)
    stats = reg.MatrixStats(dense)
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 200_000)
    card = CardSpace(("ell", "bell"))
    seen = set()
    for pt in card.points(stats):
        at = card.launch(stats, pt)
        try:
            ops.prepare(dense, pt.fmt, pt.schedule, device="cpu")
            admitted = True
        except InfeasibleConfig:
            admitted = False
        assert admitted == at.feasible
        seen.add(admitted)
    assert seen == {True, False}


def test_a_format_without_card_launch_keeps_every_schedule(with_bcsr):
    assert reg.get_format("bcsr").card_launch is None
    stats = reg.MatrixStats(_dense(2))
    points = CardSpace(("bcsr",)).points(stats)
    assert [p.schedule for p in points] == list(space.schedule_space())


# ------------------------- (ii) the reference-equal space is unchanged
def test_reference_knobs_choices_and_spaces_unchanged():
    assert space.KNOBS == ref_space.KNOBS and space.PAPER_KNOBS == ref_space.PAPER_KNOBS
    for name in ("ROWS_PER_BLOCK_CHOICES", "NNZ_TILE_CHOICES", "UNROLL_CHOICES",
                 "ACCUM_DTYPE_CHOICES", "X_RESIDENCY_CHOICES", "DIMENSION_SEMANTICS_CHOICES"):
        assert getattr(common, name) == getattr(ref_common, name), name
    assert DEFAULT_SCHEDULE.as_dict() == ref_common.DEFAULT_SCHEDULE.as_dict()
    assert [s.as_dict() for s in space.schedule_space()] == [
        s.as_dict() for s in ref_space.schedule_space()]
    assert [c.as_dict() for c in space.full_space()] == [c.as_dict() for c in ref_space.full_space()]
    assert space.space_size() == ref_space.space_size() == 4 * 448


# ------------------------------------------ faster scans, the same arrays
@pytest.mark.parametrize("kind", ["fem", "nan", "empty_rows", "empty_cols", "strided", "f64"])
def test_scan_equals_np_nonzero(kind):
    dense = random_matrix(120, 7.0, "powerlaw", seed=3)
    if kind == "nan":
        dense[4, 5], dense[7, 0] = np.nan, -0.0
    elif kind == "empty_rows":
        dense = dense[:0]
    elif kind == "empty_cols":
        dense = dense[:, :0]
    elif kind == "strided":
        dense = dense.T[::2]
    elif kind == "f64":
        dense = dense.astype(np.float64)
    rows, cols, counts, values = formats._scan(dense)
    want = np.nonzero(dense)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])
    np.testing.assert_array_equal(counts, (dense != 0).sum(axis=1))
    np.testing.assert_array_equal(values, dense[want])
    assert values.dtype == dense.dtype


def test_shared_nonzeros_scans_once_and_leaves_the_array_as_it_was(monkeypatch):
    dense = _dense(1)
    alone = [ops.prepare(dense, f, s, device="cpu") for f in ("csr", "ell", "sell")
             for s in (DEFAULT_SCHEDULE, KernelSchedule(rows_per_block=8, nnz_tile=256))]
    scans = []
    real = np.flatnonzero
    monkeypatch.setattr(np, "flatnonzero", lambda a: scans.append(1) or real(a))
    with formats.shared_nonzeros(dense):
        assert not dense.flags.writeable
        with pytest.raises(ValueError):
            dense[0, 0] = 1.0
        shared = [ops.prepare(dense, f, s, device="cpu") for f in ("csr", "ell", "sell")
                  for s in (DEFAULT_SCHEDULE, KernelSchedule(rows_per_block=8, nnz_tile=256))]
    assert len(scans) == 1 and dense.flags.writeable
    for a, b in zip(alone, shared):
        for name in a.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            assert (x.equal(y) if hasattr(x, "equal") else x == y), name
    with pytest.raises(TypeError):
        with formats.shared_nonzeros([[1.0]]):
            pass


# --------------------------- (iii) the measured dataset, a scripted timer
def _scripted(times: dict, spread: float = 0.02):
    """A timer that calls the point once and returns its scripted median
    (default 1.0 ms) with quartiles ``spread`` apart; a call it has timed
    before (the re-timing in turns) comes ``spread / 2`` above and below in
    turn, so the turns are ``spread`` apart too."""
    seen = []
    turns = {}  # each timed call -> its timings so far

    def timer(fn, cfg):
        fn()
        seen.append(cfg)
        t = times.get(cfg, 1.0)
        n = turns[fn] = turns.get(fn, 0) + 1
        if n > 1:
            t *= 1 + (spread / 2 if n % 2 == 0 else -spread / 2)
        return {"median_ms": t, "q1_ms": t * (1 - spread / 2), "q3_ms": t * (1 + spread / 2)}
    timer.seen = seen
    return timer


def _card_dataset(monkeypatch, times, formats_=None, n=2):
    mats = {f"m{i}": _dense(i) for i in range(n)}
    converted = []
    real = ops.compile_spmv

    def counting(dense, fmt, schedule, **kw):
        out = real(dense, fmt, schedule, **kw)
        converted.append((id(dense), fmt, tuple(out.mat.data.shape), getattr(out.mat, "C", None)))
        return out
    monkeypatch.setattr(ops, "compile_spmv", counting)
    timer = _scripted(times)
    points = []
    ds = collect_dataset(matrices=mats, space=CardSpace(formats_), measure=True, device="cpu",
                         timer=timer, on_point=lambda *a: points.append(a))
    return ds, mats, converted, timer, points


def test_collect_times_every_card_point_and_converts_once_per_geometry(monkeypatch):
    ds, mats, converted, timer, seen = _card_dataset(monkeypatch, {})
    card = CardSpace()
    for name, dense in mats.items():
        stats = reg.MatrixStats(dense)
        points = card.points(stats)
        measured = [r for r in ds.for_matrix(name) if is_measured(r)]
        model = [r for r in ds.for_matrix(name) if not is_measured(r)]
        # each point: one model record, one measured record carrying its schedule
        assert [r.config for r in measured] == [r.config for r in model] == points
        assert all(r.source == "measured_cpu" and r.feasible and r.latency == 1e-3
                   and math.isnan(r.energy) for r in measured)
        geometries = {(p.fmt, card.launch(stats, p).geometry) for p in points}
        assert ds.meta["conversions"][name] == len(geometries)
    assert len(converted) == sum(ds.meta["conversions"].values())
    assert len(set(converted)) == len(converted)  # one conversion per geometry
    # every point once, then the re-timing's calls (its candidates in turns)
    retimed = sum(ds.meta["retime"][m]["calls"] for m in mats)
    assert len(timer.seen) == len(seen) + retimed == sum(ds.meta["calls"].values())
    assert ds.meta["calls"] == {f: sum(c.fmt == f for c in timer.seen) for f in FORMATS}
    assert ds.meta["spread"] == {name: pytest.approx(0.02) for name in mats}
    assert set(ds.meta["seconds"]) == {"generation", "features", "model", "conversion", "timing"}
    # on_point sees the timed kernel on its storage and its y
    name, cfg, kernel, x, y = seen[0]
    assert kernel.schedule == cfg.schedule and y.shape == (mats[name].shape[0],)
    np.testing.assert_allclose(y.numpy(), mats[name] @ x.numpy(), rtol=1e-4, atol=1e-5)


def test_refused_geometries_are_infeasible_records_without_a_conversion(monkeypatch):
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 200_000)
    ds, mats, converted, timer, _ = _card_dataset(monkeypatch, {}, ("ell",), n=1)
    measured = [r for r in ds.records if is_measured(r)]
    refused = [r for r in measured if not r.feasible]
    assert refused and all(r.latency == math.inf for r in refused)
    assert len(converted) == ds.meta["conversions"]["m0"] and len(timer.seen) == len(
        measured) - len(refused) + ds.meta["retime"]["m0"]["calls"]


def test_a_point_its_check_refuses_is_infeasible_and_never_a_label(monkeypatch):
    mats = {"m0": _dense(0)}
    fast = _cfg(rows_per_block=8, unroll=8, accum_dtype="bfloat16")
    refuse = lambda name, cfg, kernel, x, y: cfg.schedule.accum_dtype == "float32"
    ds = collect_dataset(matrices=mats, space=card_compile_time_space(), measure=True,
                         device="cpu", timer=_scripted({fast: 0.1}), on_point=refuse)
    measured = [r for r in ds.records if is_measured(r)]
    assert {r.feasible for r in measured if r.config.schedule.accum_dtype == "float32"} == {True}
    assert not any(r.feasible for r in measured if r.config.schedule.accum_dtype == "bfloat16")
    best = ds.best_record("m0", "latency")
    assert is_measured(best) and best.config.schedule.accum_dtype == "float32"


def _cfg(fmt="csr", **kw):
    return TuningConfig(fmt, DEFAULT_SCHEDULE.replace(**kw))


def test_ties_within_the_spread_go_to_the_default_then_fewer_rows_and_accumulators(monkeypatch):
    default = _cfg()
    near = _cfg(rows_per_block=32, unroll=2)  # 0.5 % faster than the default: a tie
    far = _cfg(rows_per_block=128, unroll=4)
    times = {default: 1.0, near: 0.995}
    ds, *_ = _card_dataset(monkeypatch, times, ("csr",), n=1)
    assert ds.best_record("m0", "latency", formats=("csr",)).config == default
    # beyond the spread the fastest wins
    ds, *_ = _card_dataset(monkeypatch, {default: 1.0, near: 0.995, far: 0.5}, ("csr",), n=1)
    assert ds.best_record("m0", "latency").config == far
    # the default out of reach: among the ties, fewer rows per block, then unroll
    a, b, c = _cfg(rows_per_block=64, unroll=2), _cfg(rows_per_block=16, unroll=8), _cfg(
        rows_per_block=16, unroll=4)
    ds, *_ = _card_dataset(monkeypatch, {default: 2.0, a: 0.50, b: 0.505, c: 0.508}, ("csr",),
                           n=1)
    assert ds.best_record("m0", "latency").config == c
    # the spreads travel with the dataset: the in-turn one decides, and
    # without a re-timing (a dataset collected before it) the first pass's
    ds.meta["retime"]["m0"]["spread"] = 0.0
    assert ds.best_record("m0", "latency").config == a
    del ds.meta["retime"]["m0"]
    assert ds.best_record("m0", "latency").config == c
    ds.meta["spread"]["m0"] = 0.0
    assert ds.best_record("m0", "latency").config == a


def test_labels_come_from_the_records_that_carry_them(monkeypatch, tmp_path):
    fast = _cfg(rows_per_block=8, unroll=8)
    ds, *_ = _card_dataset(monkeypatch, {fast: 0.2}, ("csr", "ell"), n=2)
    ds.save(tmp_path / "card.json")
    back = TuningDataset.load(tmp_path / "card.json")
    for d in (ds, back):
        for m in ("m0", "m1"):
            assert d.best_record(m, "latency").config == fast
            assert is_measured(d.best_record(m, "latency"))
            for obj in ("energy", "power", "efficiency"):
                best = d.best_record(m, obj)
                assert not is_measured(best) and not math.isnan(best.objective(obj))
    assert back.meta["spread"] == ds.meta["spread"]


# ---------------------------------------------- (iv) what fit learns
def _with_measured(model_ds, fast_of: dict):
    """The model dataset plus one measured record per (matrix, config) of
    its CSR records: 1 ms, except ``fast_of[matrix]`` at 0.1 ms."""
    recs = list(model_ds.records)
    for r in model_ds.records:
        if r.config.fmt == "csr" and r.feasible:
            t = 1e-4 if r.config == fast_of[r.matrix] else 1e-3
            recs.append(TuningRecord(r.matrix, r.features, r.config, t, math.nan, math.nan,
                                     math.nan, True, "measured_cuda"))
    return TuningDataset(recs, dict(model_ds.meta))


@pytest.fixture(scope="module")
def model_dataset():
    mats = {f"m{i}": random_matrix(120 + 40 * i, 4.0 + 3 * i, p, seed=20 + i)
            for i, p in enumerate(["fem", "powerlaw", "block", "banded", "denserows", "fem"])}
    return collect_dataset(matrices=mats, space=list(space.full_space(
        rows_per_block=(8, 64, 256), nnz_tile=(128, 512), unroll=(1, 8))))


def test_fit_takes_latency_from_measured_records_and_the_rest_from_the_model(model_dataset):
    picks = [_cfg(rows_per_block=8, unroll=8), _cfg(rows_per_block=256, unroll=1),
             _cfg(rows_per_block=64, unroll=8, accum_dtype="bfloat16")]
    fast_of = {m: picks[i % 3] for i, m in enumerate(model_dataset.matrices)}
    ds = _with_measured(model_dataset, fast_of)
    pred = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=10_000, device="cpu")).fit(ds)
    model_pred = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=10_000,
                                                   device="cpu")).fit(model_dataset)
    for m in ds.matrices:
        feats = ds.for_matrix(m)[0].features
        assert pred.predict_schedule(feats, "latency") == fast_of[m].schedule
        assert pred.predict_format(feats, "latency") == "csr"  # only CSR was measured
        for obj in ("energy", "power", "efficiency"):
            assert pred.predict_schedule(feats, obj) == model_pred.predict_schedule(feats, obj)
            assert pred.predict_format(feats, obj) == model_pred.predict_format(feats, obj)
            cfg = model_dataset.best_record(m, obj).config
            assert pred.estimate_objective(feats, cfg, obj) == pytest.approx(
                model_pred.estimate_objective(feats, cfg, obj), rel=1e-12)
        # the latency regressor learnt the measured seconds (the model's
        # are two or more decades lower at these sizes)
        for cfg in (fast_of[m], _cfg(rows_per_block=8, unroll=1)):
            assert 0.999e-4 <= pred.estimate_objective(feats, cfg, "latency") <= 1.001e-3
            assert model_pred.estimate_objective(feats, cfg, "latency") < 1e-5


def test_format_labels_come_from_matrices_that_cover_every_format(model_dataset):
    # one matrix measured (and modelled) over CSR alone: it labels no format
    csr_only = [r for r in model_dataset.records if r.matrix != "m0" or r.config.fmt == "csr"]
    ds = TuningDataset(csr_only, dict(model_dataset.meta))
    pred = AutoSpmvPredictor(PredictorConfig(device="cpu")).fit(ds)
    rest = TuningDataset([r for r in model_dataset.records if r.matrix != "m0"],
                         dict(model_dataset.meta))
    ref = AutoSpmvPredictor(PredictorConfig(device="cpu")).fit(rest)
    for m in model_dataset.matrices:
        feats = model_dataset.for_matrix(m)[0].features
        for obj in OBJECTIVES:
            assert pred.predict_format(feats, obj) == ref.predict_format(feats, obj)


def test_fit_on_model_records_alone_is_the_references(model_dataset, tmp_path):
    model_dataset.save(tmp_path / "model.json")
    ours = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=400, device="cpu")).fit(
        TuningDataset.load(tmp_path / "model.json"))
    theirs = RefPredictor(RefPredictorConfig(max_regressor_samples=400)).fit(
        RefDataset.load(tmp_path / "model.json"))
    for i, p in enumerate(["fem", "powerlaw", "banded"]):
        dense = random_matrix(200, 6.0 + i, p, seed=40 + i)
        fa, fb = extract_features(dense), ref_features(dense)
        for obj in OBJECTIVES:
            assert ours.predict_format(fa, obj) == theirs.predict_format(fb, obj)
            sa, sb = ours.predict_schedule(fa, obj), theirs.predict_schedule(fb, obj)
            assert sa.as_dict() == sb.as_dict()
            for fmt in FORMATS:
                a = ours.estimate_objective(fa, space.TuningConfig(fmt, sa), obj)
                b = theirs.estimate_objective(fb, ref_space.TuningConfig(fmt, sb), obj)
                assert a == pytest.approx(b, rel=1e-9)
