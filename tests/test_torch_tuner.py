"""Port vs reference: tuning space, cost model, dataset, predictors and the
run-time conversion gate.

The cost-model formulas take the hardware profile as a parameter, so the
port is fed a profile holding the reference's constants (copied here, field
by field, from ``repro.core.objectives.TPU_V5E``) and must reproduce the
reference's values to ``rtol=1e-9``. Records, labels, schedules and chosen
formats are exact."""

import dataclasses
import json
import math

import numpy as np
import pytest

from repro.core import objectives as ref_obj
from repro.core import tuning_space as ref_space
from repro.core.autotuner import RunTimePlan as RefRunTimePlan
from repro.core.autotuner import should_convert as ref_should_convert
from repro.core.dataset import TuningDataset as RefDataset
from repro.core.dataset import collect_dataset as ref_collect
from repro.core.features import extract_features as ref_features
from repro.core.overhead import OverheadPredictor as RefOverhead
from repro.core.overhead import OverheadSample as RefOverheadSample
from repro.core.predictor import AutoSpmvPredictor as RefPredictor
from repro.core.predictor import PredictorConfig as RefPredictorConfig
from repro.kernels.common import KernelSchedule as RefSchedule
from repro.sparse.generate import MATRIX_NAMES, generate_by_name, random_matrix
from repro_torch.core import objectives as obj
from repro_torch.core import tuning_space as space
from repro_torch.core.autotuner import AutoSpMV, RunTimePlan, should_convert
from repro_torch.core.dataset import TuningDataset, collect_dataset
from repro_torch.core.features import extract_features
from repro_torch.core.overhead import OverheadPredictor, OverheadSample, measure_overheads
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.kernels.common import KernelSchedule
from repro_torch.ml.model_zoo import CLASSIFIER_ZOO, REGRESSOR_ZOO

from torch_port_helpers import FORMATS, SCHEDULE_KW

SCALE = 0.0015
NAMES = MATRIX_NAMES[:6]

# the reference profile's constants, handed to the port from the test file
REFERENCE_PROFILE = obj.HardwareProfile(**dataclasses.asdict(ref_obj.TPU_V5E))


# ------------------------------------------------------------ tuning space
def test_tuning_space_identical():
    ours = [c.as_dict() for c in space.full_space()]
    theirs = [c.as_dict() for c in ref_space.full_space()]
    assert ours == theirs and len(ours) == space.space_size()
    assert space.KNOBS == ref_space.KNOBS and space.ALL_KNOBS == ref_space.ALL_KNOBS
    assert space.DEFAULT_CONFIG.as_dict() == ref_space.DEFAULT_CONFIG.as_dict()
    assert [c.as_dict() for c in space.compile_time_space()] == [
        c.as_dict() for c in ref_space.compile_time_space()
    ]


def test_features_identical():
    for pattern in ("fem", "powerlaw", "block"):
        dense = random_matrix(180, 9.0, pattern, seed=2)
        assert extract_features(dense).dict() == ref_features(dense).dict()


# --------------------------------------------------------------- cost model
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pattern", ["fem", "powerlaw", "block"])
def test_cost_model_equals_reference_with_injected_constants(fmt, pattern):
    dense = random_matrix(220, 10.0, pattern, seed=5).astype(np.float32)
    ours, theirs = obj.CostModel(REFERENCE_PROFILE), ref_obj.TpuCostModel()
    stats, ref_stats = obj.MatrixStats(dense), ref_obj.MatrixStats(dense)
    for kw in SCHEDULE_KW + [dict(x_residency="stream"), dict(rows_per_block=512, unroll=8)]:
        a = ours.evaluate(stats, fmt, KernelSchedule(**kw))
        b = theirs.evaluate(ref_stats, fmt, RefSchedule(**kw))
        assert a.feasible == b.feasible
        for name in obj.OBJECTIVES:
            if math.isinf(b.get(name)):
                assert a.get(name) == b.get(name)
            else:
                assert a.get(name) == pytest.approx(b.get(name), rel=1e-9)


def test_default_profile_is_the_h100_and_holds_no_reference_constant():
    hw = obj.H100_SXM
    assert obj.CostModel().hw is hw and obj.HARDWARE == {"h100_sxm": hw}
    assert (hw.hbm_bw, hw.mxu_flops_bf16, hw.mxu_flops_f32, hw.vpu_flops_f32) == (
        3.35e12, 989e12, 495e12, 67e12)
    assert hw.vmem_bytes == 50 * 1024 * 1024 and hw.p_max == 700.0
    ours, theirs = dataclasses.asdict(hw), dataclasses.asdict(ref_obj.TPU_V5E)
    assert not [k for k in ours if ours[k] == theirs[k]]
    # and it evaluates: finite objectives, ELL padding costs efficiency
    dense = random_matrix(200, 8.0, "powerlaw", seed=1)
    stats = obj.MatrixStats(dense)
    vals = {f: obj.CostModel().evaluate(stats, f, KernelSchedule()) for f in FORMATS}
    assert all(math.isfinite(v.latency) and v.latency > 0 for v in vals.values())
    assert vals["ell"].efficiency < vals["csr"].efficiency


def test_calibrated_model_round_trip_and_unknown_hardware(tmp_path):
    samples = {"csr": [(1e-4, 3e-4), (2e-4, 5e-4), (4e-4, 9e-4)], "ell": [(1e-4, 1.5e-4)]}
    ours = obj.CalibratedCostModel.fit(samples)
    theirs = ref_obj.CalibratedCostModel.fit(samples)
    for fmt in samples:
        assert ours.corrections[fmt].as_dict() == pytest.approx(
            theirs.corrections[fmt].as_dict(), rel=1e-12)
    path = tmp_path / "cal.json"
    ours.save(path)
    back = obj.CalibratedCostModel.load(path)
    assert back.hw is obj.H100_SXM
    assert back.corrections["csr"].as_dict() == ours.corrections["csr"].as_dict()
    # a calibration fitted for other hardware is refused, not silently rebased
    theirs.save(tmp_path / "ref.json")
    with pytest.raises(ValueError):
        obj.CalibratedCostModel.load(tmp_path / "ref.json")
    assert obj.CalibratedCostModel.load(tmp_path / "ref.json", hw=obj.H100_SXM).hw is obj.H100_SXM


def test_measure_formats_times_the_oracles_on_the_named_device():
    dense = random_matrix(120, 6.0, "fem", seed=3)
    times = obj.measure_formats(dense, reps=1, warmup=0, device="cpu")
    assert set(times) == set(FORMATS) and all(t > 0 for t in times.values())
    with pytest.raises(RuntimeError):
        obj.measure_formats(dense, reps=1, warmup=0)  # no device: needs the card


# ------------------------------------------------------------------ dataset
@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One dataset per package over the same matrices with the same
    constants, plus the JSON files that carry each across."""
    tmp = tmp_path_factory.mktemp("ds")
    ours = collect_dataset(scale=SCALE, names=NAMES, n_extra=2, hw=REFERENCE_PROFILE)
    theirs = ref_collect(scale=SCALE, names=NAMES, n_extra=2)
    ours.save(tmp / "port.json")
    theirs.save(tmp / "ref.json")
    return ours, theirs, tmp


def _rows(path):
    blob = json.loads(path.read_text())
    return blob["records"]


def test_collect_dataset_records_equal(datasets):
    ours, theirs, tmp = datasets
    assert len(ours) == len(theirs) and ours.matrices == theirs.matrices
    a, b = _rows(tmp / "port.json"), _rows(tmp / "ref.json")
    for ra, rb in zip(a, b):
        assert (ra["matrix"], ra["features"], ra["config"], ra["feasible"], ra["source"]) == (
            rb["matrix"], rb["features"], rb["config"], rb["feasible"], rb["source"])
        for name in obj.OBJECTIVES:
            if rb[name] in (float("inf"), 0.0):
                assert ra[name] == rb[name]
            else:
                assert ra[name] == pytest.approx(rb[name], rel=1e-9)


def test_dataset_json_crosses_both_ways(datasets):
    ours, theirs, tmp = datasets
    from_ref = TuningDataset.load(tmp / "ref.json")  # reference -> port
    to_ref = RefDataset.load(tmp / "port.json")  # port -> reference
    assert len(from_ref) == len(theirs) and len(to_ref) == len(ours)
    for m in theirs.matrices:
        for o in obj.OBJECTIVES:
            assert from_ref.best_record(m, o).config.as_dict() == (
                theirs.best_record(m, o).config.as_dict())
            assert to_ref.best_record(m, o).config.as_dict() == (
                ours.best_record(m, o).config.as_dict())
        assert from_ref.default_record(m).latency == theirs.default_record(m).latency
    assert from_ref.meta["hw"] == "tpu_v5e"


def test_default_collection_is_labelled_by_the_h100_profile():
    ds = collect_dataset(scale=SCALE, names=NAMES[:2], n_extra=0,
                         space=list(space.compile_time_space(nnz_tile=(128,), unroll=(1,),
                                                             x_residency=("vmem",))))
    assert ds.meta["hw"] == "h100_sxm"
    assert {r.source for r in ds.records} == {"model_h100_sxm"}
    assert all(r.feasible and math.isfinite(r.latency) for r in ds.records)


# --------------------------------------------------------------- predictors
@pytest.fixture(scope="module")
def predictors(datasets):
    _, theirs, tmp = datasets
    ours = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=1000)).fit(
        TuningDataset.load(tmp / "ref.json"))
    ref = RefPredictor(RefPredictorConfig(max_regressor_samples=1000)).fit(theirs)
    return ours, ref


def _held_out():
    mats = [generate_by_name(n, scale=SCALE * 1.3) for n in MATRIX_NAMES[8:14]]
    mats += [random_matrix(300, 5.0 + 3 * i, p, seed=50 + i)
             for i, p in enumerate(["fem", "powerlaw", "block", "banded"])]
    return mats


@pytest.mark.parametrize("objective", obj.OBJECTIVES)
def test_predictions_equal_on_held_out_matrices(predictors, objective):
    ours, ref = predictors
    for dense in _held_out():
        fa, fb = extract_features(dense), ref_features(dense)
        assert ours.predict_format(fa, objective) == ref.predict_format(fb, objective)
        sa, sb = ours.predict_schedule(fa, objective), ref.predict_schedule(fb, objective)
        assert sa.as_dict() == sb.as_dict()
        for fmt in FORMATS:
            a = ours.estimate_objective(fa, space.TuningConfig(fmt, sa), objective)
            b = ref.estimate_objective(fb, ref_space.TuningConfig(fmt, sb), objective)
            assert a == pytest.approx(b, rel=1e-9)


def test_model_zoo_holds_the_ported_families_under_reference_names():
    from repro.ml.model_zoo import CLASSIFIER_ZOO as REF_C, REGRESSOR_ZOO as REF_R

    assert set(CLASSIFIER_ZOO) == {"decision_tree"} <= set(REF_C)
    assert set(REGRESSOR_ZOO) == {"bayesian_ridge", "lasso", "lars", "decision_tree"} <= set(REF_R)
    for zoo, ref in ((CLASSIFIER_ZOO, REF_C), (REGRESSOR_ZOO, REF_R)):
        for name, entry in zoo.items():
            assert entry["space"] == ref[name]["space"]
            assert entry["defaults"] == ref[name]["defaults"]


# ------------------------------------------------------- overhead + the gate
def _overhead_samples(cls, feats_fn):
    out = []
    for i, n in enumerate(NAMES):
        dense = generate_by_name(n, scale=SCALE)
        c = {f: 1e-3 * (i + 1) * (j + 1) for j, f in enumerate(FORMATS)}
        out.append(cls(n, feats_fn(dense), 2e-4 * (i + 1), c))
    return out


def test_overhead_predictor_equal_on_shared_samples():
    ours = OverheadPredictor().fit(_overhead_samples(OverheadSample, extract_features))
    ref = RefOverhead().fit(_overhead_samples(RefOverheadSample, ref_features))
    for dense in _held_out()[:4]:
        fa, fb = extract_features(dense), ref_features(dense)
        for fmt in FORMATS:
            assert ours.predict_c(fa, fmt) == pytest.approx(ref.predict_c(fb, fmt), rel=1e-9, abs=1e-15)
            assert ours.total_overhead(fa, fmt) == pytest.approx(
                ref.total_overhead(fb, fmt), rel=1e-9, abs=1e-15)


def test_measure_overheads_needs_a_device_and_measures_every_format():
    dense = generate_by_name(NAMES[0], scale=SCALE)
    s = measure_overheads(dense, "m", device="cpu")
    assert set(s.c_latency) == set(FORMATS) and s.f_latency > 0
    with pytest.raises(RuntimeError):
        measure_overheads(dense, "m")


@pytest.mark.parametrize("n_iterations", [1, 100, 10_000, 1_000_000])
def test_should_convert_gate(n_iterations):
    cases = [
        ("ell", 1.0, 2e-6, 1e-2, 5e-3),
        ("ell", -1.0, 2e-6, 1e-2, 5e-3),  # negative gain never converts
        ("csr", 1.0, 2e-6, 1e-2, 5e-3),  # already held
        ("sell", 0.5, 1e-9, 1.0, 0.5),
    ]
    for fmt, gain, lat_gain, oh, c in cases:
        a = RunTimePlan(fmt, gain, lat_gain, oh, c)
        b = RefRunTimePlan(fmt, gain, lat_gain, oh, c)
        for override in (None, 0.0, c):
            assert should_convert(a, n_iterations, "csr", overhead_s=override) == (
                ref_should_convert(b, n_iterations, "csr", overhead_s=override))
    assert should_convert(RunTimePlan("ell", 1.0, 2e-6, 1e-2), 10_000, "csr")
    assert not should_convert(RunTimePlan("ell", 1.0, 2e-6, 1e-2), 1_000, "csr")


def test_plans_equal_through_autospmv(predictors):
    from repro.core.autotuner import AutoSpMV as RefAutoSpMV

    ours, ref = predictors
    oh = OverheadPredictor().fit(_overhead_samples(OverheadSample, extract_features))
    ref_oh = RefOverhead().fit(_overhead_samples(RefOverheadSample, ref_features))
    a, b = AutoSpMV(ours, oh, device="cpu"), RefAutoSpMV(ref, ref_oh)
    for dense in _held_out()[:5]:
        fa, fb = extract_features(dense), ref_features(dense)
        for o in obj.OBJECTIVES:
            pa, pb = a.plan_compile_time(fa, o), b.plan_compile_time(fb, o)
            assert pa.schedule.as_dict() == pb.schedule.as_dict()
            assert pa.predicted == pytest.approx(pb.predicted, rel=1e-9)
            ra, rb = a.plan_run_time(fa, o), b.plan_run_time(fb, o)
            assert ra.best_format == rb.best_format
            assert dataclasses.astuple(ra)[1:] == pytest.approx(
                dataclasses.astuple(rb)[1:], rel=1e-9, abs=1e-18)
    # the partitioned run-time mode agrees too, scored on the reference's constants
    dense = _held_out()[0]
    pa = a.plan_partitioned(dense, "latency", cost_model=obj.CostModel(REFERENCE_PROFILE))
    pb = b.plan_partitioned(dense, "latency")
    assert (pa.n_blocks, pa.formats, pa.monolithic_fmt) == (pb.n_blocks, pb.formats, pb.monolithic_fmt)
    assert [bp.schedule.as_dict() for bp in pa.blocks] == [bp.schedule.as_dict() for bp in pb.blocks]
    assert pa.modeled.latency == pytest.approx(pb.modeled.latency, rel=1e-9)
