"""The cost model of the card's kernels, on the CPU.

``CardCostModel`` prices the launches B1-B4 make (``FormatSpec.card_work``,
from the integer launch plans) with constants fitted on the card
(``fit_card_profile``); ``build_tuner`` labels with it on a CUDA device and
keeps the reference-equal ``CostModel`` on the CPU. BELL's storage guard
charges the storage ``bell_from_dense`` builds, where the reference charges
an occupancy bound (a stated difference). A measured collection times its
candidates again in turns and keeps the §5.3 overhead at the matrix's size
(``overhead_samples``). A scripted timer stands in for CUDA events."""

import json
import math

import numpy as np
import pytest

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels.common import InfeasibleConfig as RefInfeasible
from repro.sparse import formats as ref_formats
from repro.sparse import registry as ref_reg
from repro.sparse.generate import random_matrix
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.dataset import TuningDataset, collect_dataset, config_of, is_measured
from repro_torch.core.objectives import (
    CARD_TERMS,
    H100_CARD,
    CardCostModel,
    CardProfile,
    CostModel,
    card_terms,
    fit_card_profile,
)
from repro_torch.core.overhead import OverheadPredictor, overhead_samples
from repro_torch.core.session import AutoSpmvSession, build_tuner
from repro_torch.core.tuning_space import CardSpace, TuningConfig, full_space, tie_order
from repro_torch.kernels import ops
from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    ROWS_PER_BLOCK_CHOICES,
    InfeasibleConfig,
    KernelSchedule,
)
from repro_torch.partition.partitioner import partition_rows
from repro_torch.partition.plan import plan_for_partition, sweep_formats
from repro_torch.sparse import formats
from repro_torch.sparse import registry as reg
from repro_torch.sparse.generate import MATRIX_NAMES

from torch_port_helpers import assert_same_storage, hetero_matrix

CASES = [(160, 9.0, "fem"), (210, 14.0, "powerlaw"), (192, 20.0, "block")]


def _dense(i):
    n, avg, pattern = CASES[i]
    return random_matrix(n, avg, pattern, seed=40 + i).astype(np.float32)


def _bell_bytes(dense, br):
    mat = formats.bell_from_dense(dense, br=br, device="cpu")
    nbr, mb, _, bc = mat.data.shape
    return nbr * mb * br * bc * 8


# ----------------------------------------------- BELL's true storage guard
@pytest.mark.parametrize("case", range(len(CASES)))
def test_bell_prepare_admits_exactly_what_card_launch_calls_feasible(monkeypatch, case):
    dense = _dense(case)
    stats = reg.MatrixStats(dense)
    true = {br: _bell_bytes(dense, min(br, 256)) for br in ROWS_PER_BLOCK_CHOICES}
    bound = (min(true.values()) + max(true.values())) // 2
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", bound)
    seen = set()
    for br in ROWS_PER_BLOCK_CHOICES:
        sched = KernelSchedule(rows_per_block=br)
        at = reg.get_format("bell").card_launch(stats, sched, 132)
        try:
            mat = ops.prepare(dense, "bell", sched, device="cpu")
            admitted = True
        except InfeasibleConfig:
            admitted = False
        assert admitted == at.feasible == (true[br] <= bound)
        if admitted:
            nbr, mb, height, _ = mat.data.shape
            assert at.geometry == (height, nbr, mb)
        seen.add(admitted)
    assert seen == {True, False}


def test_bell_guard_charges_the_true_storage_where_the_reference_charges_its_bound(monkeypatch):
    """A banded matrix: two blocks of 8 x 128 in each block row, 128 in all,
    but min(nnz, block rows x block columns) = 256 blocks for the reference.
    Between the two sizes the reference refuses what the port stores; the
    port's container is the reference converter's."""
    dense = random_matrix(512, 6.0, "banded", seed=3).astype(np.float32)
    sched, ref_sched = KernelSchedule(rows_per_block=8), RefSchedule(rows_per_block=8)
    true = _bell_bytes(dense, 8)
    ref_bound = 256 * 8 * 128 * 8  # the reference's charge
    assert true < ref_bound
    for module in (reg, ref_reg):
        monkeypatch.setattr(module, "MAX_STORAGE_BYTES", (true + ref_bound) // 2)
    with pytest.raises(RefInfeasible):
        ref_prepare(dense, "bell", ref_sched)
    port = ops.prepare(dense, "bell", sched, device="cpu")
    assert_same_storage("bell", ref_formats.bell_from_dense(dense, br=8, bc=128), port)
    # both refuse what neither bound holds, and both admit what both hold
    for module, bound in ((reg, true - 1), (ref_reg, true - 1)):
        monkeypatch.setattr(module, "MAX_STORAGE_BYTES", bound)
    with pytest.raises(InfeasibleConfig):
        ops.prepare(dense, "bell", sched, device="cpu")
    with pytest.raises(RefInfeasible):
        ref_prepare(dense, "bell", ref_sched)


@pytest.mark.parametrize("kind", ["f64_underflow", "nan", "empty_rows"])
def test_bell_converter_from_the_scan_is_the_reference_converter(kind):
    dense = random_matrix(150, 5.0, "powerlaw", seed=8)
    if kind == "f64_underflow":
        dense = dense.astype(np.float64)
        dense[3, 300 % 150] = 1e-50  # rounds to 0 in float32: not stored
        dense[140, :] = 0.0
        dense[140, 7] = 1e-50
    elif kind == "nan":
        dense = dense.astype(np.float32)
        dense[5, 9] = np.nan
    else:
        dense = dense.astype(np.float32)
        dense[:40] = 0.0
    for br in (8, 16, 64):
        ref = ref_formats.bell_from_dense(dense, br=br, bc=128)
        port = formats.bell_from_dense(dense, br=br, bc=128, device="cpu")
        assert_same_storage("bell", ref, port)
        with formats.shared_nonzeros(np.asarray(dense)) as d:
            occ = formats.bell_occupancy(d, br)
            assert occ.max_blocks == port.data.shape[1]
            assert_same_storage("bell", ref, formats.bell_from_dense(
                d, br=br, bc=128, device="cpu", occupancy=occ))
        # card_launch counts blocks from the values before the cast: it never
        # charges less than prepare stores
        assert reg.MatrixStats(dense).block_occupancy(br, 128)[1] >= port.data.shape[1]


# ------------------------------- the card model sees the guards, blocks too
@pytest.mark.parametrize("case", range(len(CASES)))
def test_card_model_prices_exactly_the_launches_the_card_runs(monkeypatch, case):
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 120_000)
    stats = reg.MatrixStats(_dense(case))
    model, card = CardCostModel(), CardSpace()
    seen = set()
    for cfg in full_space():
        v = model.evaluate(stats, cfg.fmt, cfg.schedule)
        assert v.feasible == card.launch(stats, cfg).feasible
        if v.feasible:
            assert 0 < v.latency < 1e-3 and v.energy > 0 and v.power > 0 and v.efficiency > 0
        else:
            assert v.latency == math.inf
        seen.add(v.feasible)
    assert seen == {True, False}
    # the reference-equal model calls refused storage feasible: what the card
    # model repairs
    ref = CostModel()
    assert any(ref.evaluate(stats, c.fmt, c.schedule).feasible
               and not card.launch(stats, c).feasible for c in full_space())


@pytest.fixture(scope="module")
def small_tuner():
    return build_tuner(names=MATRIX_NAMES[:2], n_extra=0, fit_overhead=False, device="cpu",
                       model=CardCostModel())


def test_partition_blocks_are_feasible_only_where_the_card_runs_them(monkeypatch, small_tuner):
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 60_000)
    dense = hetero_matrix(512)
    part = partition_rows(dense, 4)
    model = CardCostModel()
    plans, _ = plan_for_partition(small_tuner.predictor, dense, part, "latency",
                                  cost_model=model)
    seen = set()
    for bp in plans:
        stats = reg.MatrixStats(dense[bp.block.row_start:bp.block.row_end])
        scored = sweep_formats(stats, (DEFAULT_SCHEDULE, KernelSchedule(rows_per_block=8)),
                               "latency", model)
        for fmt, (sched, v) in scored.items():
            assert v.feasible == reg.get_format(fmt).card_launch(stats, sched, 132).feasible
            seen.add(v.feasible)
        at = reg.get_format(bp.fmt).card_launch(stats, bp.schedule, 132)
        assert bp.modeled.feasible == at.feasible
    assert seen == {True, False}


def test_partitioned_planning_scores_with_the_tuners_model(small_tuner):
    dense = hetero_matrix(384)
    assert isinstance(small_tuner.cost_model, CardCostModel)
    plan = small_tuner.plan_partitioned(dense, "latency", block_counts=(1, 2))
    want = CardCostModel().evaluate(reg.MatrixStats(dense), plan.monolithic_fmt,
                                    plan.monolithic_schedule)
    assert plan.monolithic.latency == pytest.approx(want.latency, rel=1e-12)
    # a session without a calibration file plans with the tuner's model too
    got = AutoSpmvSession(small_tuner).partitioned_optimize(dense, "latency", max_blocks=2)
    assert got.plan.monolithic.latency == pytest.approx(want.latency, rel=1e-12)


# ------------------- calibration corrects the card model, not a TPU's
def _feed_calibration_pairs(rec, seed=8):
    rng = np.random.default_rng(seed)
    for fmt, (scale, over) in {"csr": (2.0, 3e-5), "ell": (0.5, 1e-5), "bell": (3.0, 0.0)}.items():
        for _ in range(6):
            p = float(rng.uniform(1e-5, 1e-3))
            rec.observe(bucket="b", objective="latency", fmt=fmt,
                        measured_s=over + scale * p * float(rng.uniform(0.95, 1.05)),
                        predicted_s=p)


def test_calibrate_on_a_card_tuner_corrects_the_card_model(monkeypatch, tmp_path):
    from repro_torch.core.objectives import CalibratedCostModel
    from repro_torch.telemetry.recorder import TelemetryRecorder

    from torch_port_helpers import StubPredictor

    card = CardCostModel()
    tuner = AutoSpMV(StubPredictor(DEFAULT_SCHEDULE, "csr"), device="cpu", cost_model=card)
    sess = AutoSpmvSession(tuner, cache_path=tmp_path / "t.json", telemetry=TelemetryRecorder())
    _feed_calibration_pairs(sess.telemetry)
    model = sess.calibrate()
    assert isinstance(model, CalibratedCostModel) and model.base is card
    assert set(model.corrections) == {"csr", "ell", "bell"}
    # a second calibration corrects the same base, not the corrected model
    assert sess.calibrate().base is card
    # the corrections scale the card model's latency; its guards stand
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", 400_000)  # BELL: br <= 64 only
    stats = reg.MatrixStats(_dense(2))
    seen = set()
    for cfg in full_space():
        got, want = model.evaluate(stats, cfg.fmt, cfg.schedule), card.evaluate(
            stats, cfg.fmt, cfg.schedule)
        assert got.feasible == want.feasible
        seen.add((cfg.fmt, got.feasible))
        if got.feasible:
            cal = model.corrections.get(cfg.fmt)
            scaled = want.latency if cal is None else (
                cal.launch_overhead_s + cal.latency_scale * want.latency)
            assert got.latency == pytest.approx(scaled, rel=1e-12)
    assert ("bell", False) in seen and ("bell", True) in seen
    # the file names its base, the whole profile; a restarted session loads it
    saved = json.loads((tmp_path / "t.calibration.json").read_text())
    assert saved["base"]["model"] == "CardCostModel"
    assert saved["base"]["profile"]["name"] == H100_CARD.name
    fresh = AutoSpmvSession(tuner, cache_path=tmp_path / "t.json").cost_model
    assert isinstance(fresh.base, CardCostModel) and fresh.base.profile == H100_CARD
    assert fresh.evaluate(stats, "csr", DEFAULT_SCHEDULE).latency == pytest.approx(
        model.evaluate(stats, "csr", DEFAULT_SCHEDULE).latency, rel=1e-12)
    # without a model on session or tuner, the reference's choice stands
    plain = AutoSpmvSession(AutoSpMV(StubPredictor(DEFAULT_SCHEDULE, "csr"), device="cpu"),
                            telemetry=TelemetryRecorder())
    _feed_calibration_pairs(plain.telemetry)
    assert type(plain.calibrate(save=False).base) is CostModel


# --------------------------------------------- the fit recovers a profile
KNOWN = CardProfile("known", 132, (
    ("csr", (6e-6, 5e-13, 1e-9, 1e-7, 8e-8, 5e-7, 2e-7, 4e-8)),
    ("ell", (4e-6, 6e-13, 4e-9, 2e-7, 3e-8, 0.0, 2e-8, 0.0)),
    ("sell", (7e-6, 2e-13, 2e-10, 3e-7, 8e-8, 0.0, 1.7e-7, 0.0)),
    ("bell", (2e-5, 3e-13, 6e-9, 3e-7, 0.0, 0.0, 7e-8, 0.0)),
))


def _modelled_timer(dense, profile):
    model, stats = CardCostModel(profile), reg.MatrixStats(dense)

    def timer(fn, cfg):
        fn()
        t = 1e3 * model.evaluate(stats, cfg.fmt, cfg.schedule).latency
        return {"median_ms": t, "q1_ms": t * 0.99, "q3_ms": t * 1.01}
    return timer


def _merged(parts):
    ds = TuningDataset([r for p in parts for r in p.records], dict(parts[0].meta))
    for key in ("spread", "retime", "overhead", "card_terms", "conversions"):
        ds.meta[key] = {k: v for p in parts for k, v in p.meta[key].items()}
    return ds


def test_fit_card_profile_recovers_the_profile_that_labelled_the_times():
    parts = [collect_dataset(matrices={f"m{i}": _dense(i)}, space=CardSpace(), measure=True,
                             device="cpu", timer=_modelled_timer(_dense(i), KNOWN))
             for i in range(len(CASES))]
    ds = _merged(parts)
    fitted = fit_card_profile(ds, source="scripted")
    assert fitted.source == "scripted" and fitted.n_sms == ds.meta["n_sms"] == 132
    assert {f for f, _ in fitted.coef} == {f for f, _ in KNOWN.coef}
    for m, by_point in ds.meta["card_terms"].items():
        for key, x in by_point:
            fmt = json.loads(key)["fmt"]
            assert fitted.seconds(fmt, x) == pytest.approx(KNOWN.seconds(fmt, x), rel=1e-6)
    np.testing.assert_allclose(fitted.of("csr"), KNOWN.of("csr"), rtol=1e-4, atol=1e-16)
    # leaving a matrix out leaves its records out of the fit
    assert fit_card_profile(ds, exclude=("m0", "m1", "m2")).coef == ()
    # the regressors the dataset kept are those of each launch
    stats = reg.MatrixStats(_dense(0))
    key, x = ds.meta["card_terms"]["m0"][0]
    cfg = config_of(json.loads(key))
    work = reg.get_format(cfg.fmt).card_work(stats, cfg.schedule, 132)
    assert x == card_terms(work).tolist() and len(x) == len(CARD_TERMS)


def test_committed_constants_name_the_card_and_cover_every_seed_format():
    assert {f for f, _ in H100_CARD.coef} == {"csr", "ell", "sell", "bell"}
    assert all(len(c) == len(CARD_TERMS) and min(c) >= 0 for _, c in H100_CARD.coef)
    assert "NVIDIA H100 80GB HBM3" in H100_CARD.source and "700.00 W" in H100_CARD.source


# ------------------------------------------- labels that hold between calls
def _cfg(**kw):
    return TuningConfig("csr", DEFAULT_SCHEDULE.replace(**kw))


def _two_pass_timer(first: dict, again: dict):
    """A timer whose first call of a point returns ``first`` (default 1.0
    ms) and later calls ``again`` (default: the first value), 1 % below and
    above it in turn: 2 % apart across the turns, as its quartiles are."""
    calls = {}

    def timer(fn, cfg):
        fn()
        n = calls[cfg] = calls.get(cfg, 0) + 1
        t = first.get(cfg, 1.0)
        if n > 1:
            t = again.get(cfg, t) * (0.99 if n % 2 == 0 else 1.01)
        return {"median_ms": t, "q1_ms": t * 0.99, "q3_ms": t * 1.01}
    timer.calls = calls
    return timer


def _retimed(first, again):
    timer = _two_pass_timer(first, again)
    ds = collect_dataset(matrices={"m0": _dense(0)}, space=CardSpace(("csr",)), measure=True,
                         device="cpu", timer=timer)
    return ds, timer


def test_retiming_in_turns_decides_the_label_and_keeps_one_record_per_point():
    from repro_torch.core import dataset as dataset_mod

    a, b = _cfg(rows_per_block=16, unroll=1), _cfg(rows_per_block=64, unroll=2)
    first = {_cfg(): 2.0, a: 0.50, b: 0.515}
    # first pass: a (b is 3 % slower, beyond the 2 % spread); in turns b is 6 % faster
    ds, timer = _retimed(first, {a: 0.53, b: 0.50})
    stats = reg.MatrixStats(_dense(0))
    points = CardSpace(("csr",)).points(stats)
    measured = [r for r in ds.records if is_measured(r)]
    assert [r.config for r in measured] == points  # one record per point, first-pass times
    assert {r.config: r.latency for r in measured}[b] == pytest.approx(0.515e-3)
    rt = ds.meta["retime"]["m0"]
    assert [config_of(c) for c in rt["candidates"]] == [a, b]
    assert rt["rounds"] == dataset_mod.RETIME_ROUNDS
    assert rt["calls"] == 2 * 2 * dataset_mod.RETIME_ROUNDS
    assert timer.calls[a] == timer.calls[b] == 1 + 2 * dataset_mod.RETIME_ROUNDS
    assert rt["median_ms"] == [pytest.approx(0.53), pytest.approx(0.50)]
    assert rt["spread"] == pytest.approx(0.02)  # the turns' spread, above RETIME_TIE
    assert ds.best_record("m0", "latency").config == b
    assert sum(ds.meta["calls"].values()) == len(points) + rt["calls"]
    # within the in-turn spread the tie order decides: a, fewer rows per block
    ds, _ = _retimed(first, {a: 0.505, b: 0.50})
    assert tie_order(a) < tie_order(b)
    assert ds.best_record("m0", "latency").config == a
    # the label survives a save and a load
    path_ds = TuningDataset(ds.records, json.loads(json.dumps(ds.meta)))
    assert path_ds.best_record("m0", "latency").config == a


def test_the_in_turn_spread_is_that_of_the_turns_and_at_least_retime_tie():
    """Timings that repeat exactly across the turns tie within RETIME_TIE
    (the drift between calls), and a repetition's own quartiles do not
    widen the band."""
    from repro_torch.core import dataset as dataset_mod

    a, b = _cfg(rows_per_block=16, unroll=1), _cfg(rows_per_block=64, unroll=2)

    def steady(fn, cfg):  # quartiles 10 % apart, the same median every turn
        fn()
        t = {a: 0.51, b: 0.50}.get(cfg, 1.0)
        return {"median_ms": t, "q1_ms": t * 0.95, "q3_ms": t * 1.05}
    ds = collect_dataset(matrices={"m0": _dense(0)}, space=CardSpace(("csr",)), measure=True,
                         device="cpu", timer=steady)
    assert ds.meta["retime"]["m0"]["spread"] == dataset_mod.RETIME_TIE
    assert ds.best_record("m0", "latency").config == b  # 2 % apart: beyond the band
    assert ds.meta["spread"]["m0"] == pytest.approx(0.1)  # the first pass's, as before


def test_retiming_takes_at_most_retime_max_points_of_a_format():
    from repro_torch.core import dataset as dataset_mod

    ds, _ = _retimed({}, {})  # every point ties: the fastest by tie order
    rt = ds.meta["retime"]["m0"]
    cands = [config_of(c) for c in rt["candidates"]]
    assert len(cands) == dataset_mod.RETIME_MAX
    assert cands == sorted(cands, key=tie_order)
    assert ds.best_record("m0", "latency").config == TuningConfig("csr", DEFAULT_SCHEDULE)


# ---------------------------------------------- §5.3 overhead at its size
def test_overhead_samples_come_from_the_collection_without_a_conversion(monkeypatch):
    mats = {"m0": _dense(0), "m1": _dense(1)}
    # the widest rows of m1 need ELL planes the guard refuses at the default
    R1 = -(-mats["m1"].shape[0] // 64) * 64
    W1 = -(-int((mats["m1"] != 0).sum(axis=1).max()) // 128) * 128
    monkeypatch.setattr(reg, "MAX_STORAGE_BYTES", R1 * W1 * 8 - 1)
    ds = collect_dataset(matrices=mats, space=CardSpace(("csr", "ell")), measure=True,
                         device="cpu", timer=_two_pass_timer({}, {}))
    real = ops.compile_spmv
    conversions = []
    monkeypatch.setattr(ops, "compile_spmv",
                        lambda *a, **k: conversions.append(a) or real(*a, **k))
    samples = overhead_samples(ds)
    assert not conversions
    assert [s.matrix for s in samples] == ["m0", "m1"]
    for s in samples:
        seen = ds.meta["overhead"][s.matrix]
        assert s.f_latency == seen["features_s"] > 0
        assert s.features == ds.for_matrix(s.matrix)[0].features
        assert s.c_latency["csr"] == seen["conversion_s"]["csr"] > 0
    assert "ell" in samples[0].c_latency and "ell" not in samples[1].c_latency
    assert ds.meta["overhead"]["m1"]["conversion_s"]["ell"] is None
    pred = OverheadPredictor().fit(samples)  # the formats every sample has
    assert pred.predict_c(samples[0].features, "csr") >= 0.0
    assert pred.predict_f(samples[1].features) >= 0.0


# ------------------------------------- which model labels build_tuner's data
def test_build_tuner_on_the_cpu_keeps_the_reference_equal_model(small_tuner):
    tuner = build_tuner(names=MATRIX_NAMES[:2], n_extra=0, fit_overhead=False, device="cpu")
    assert type(tuner.cost_model) is CostModel
    assert tuner.dataset.meta["model"] == "model_h100_sxm"
    assert {r.source for r in tuner.dataset.records} == {"model_h100_sxm"}
    # an explicit model labels on either device
    assert small_tuner.dataset.meta["model"] == "model_h100_card"
    assert {r.source for r in small_tuner.dataset.records} == {"model_h100_card"}
    assert isinstance(AutoSpMV(small_tuner.predictor).cost_model, type(None))
