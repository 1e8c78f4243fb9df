"""Telemetry in the port against the reference: the recorder (arm
aggregates, percentiles, calibration windows, the JSONL append-log read by
the other package, replay after a torn line), the feedback loop (exported
``TuningRecord``s, classifier refits) and the session's ``calibrate``
(corrections, ``part:*`` eviction, the ``.calibration.json`` beside the
cache, the ``H100_SXM`` fallback, the refusal of the reference's
``tpu_v5e`` file).

Both packages get the same measurement stream, drawn from one seed with
numpy. The recorder does the same float operations in both, so aggregates
are compared exactly; fitted corrections to 1e-12 relative."""

import dataclasses
import json
import math

import numpy as np
import pytest

from repro.core.autotuner import AutoSpMV as RefAutoSpMV
from repro.core.dataset import TuningDataset as RefDataset
from repro.core.dataset import collect_dataset as ref_collect
from repro.core.features import extract_features as ref_features
from repro.core.objectives import CalibratedCostModel as RefCalibrated
from repro.core.predictor import AutoSpmvPredictor as RefPredictor
from repro.core.predictor import PredictorConfig as RefPredictorConfig
from repro.core.session import AutoSpmvSession as RefSession
from repro.kernels.common import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.sparse.generate import random_matrix
from repro.telemetry import feedback as ref_feedback
from repro.telemetry import recorder as ref_recorder
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.dataset import TuningDataset
from repro_torch.core.features import extract_features
from repro_torch.core.objectives import H100_SXM, CalibratedCostModel, CostModel
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.telemetry import feedback, recorder

from torch_port_helpers import StubPredictor, hetero_matrix, reference_profile

PACKAGES = (ref_recorder, recorder)
FORMATS = ("csr", "ell", "bell", "sell")


def _stream(seed: int, n: int = 160) -> list[dict]:
    """``observe`` keyword sets: three buckets, two objectives, four formats,
    some without a prediction, some exploratory, features on the first of
    each bucket."""
    rng = np.random.default_rng(seed)
    feats = {b: extract_features(random_matrix(96, 5.0, p, seed=i)).dict()
             for i, (b, p) in enumerate((("b0", "fem"), ("b1", "powerlaw"), ("b2", "banded")))}
    out = []
    for i in range(n):
        bucket = ("b0", "b1", "b2")[int(rng.integers(3))]
        fmt = FORMATS[int(rng.integers(4))]
        kw = dict(bucket=bucket, objective=("latency", "energy")[int(rng.integers(2))],
                  fmt=fmt, measured_s=float(rng.uniform(1e-5, 3e-3)),
                  plan_id=f"{bucket}/latency/compile", exploratory=bool(rng.random() < 0.3),
                  schedule=DEFAULT_SCHEDULE.as_dict() if rng.random() < 0.5 else {})
        if rng.random() < 0.8:
            kw["predicted_s"] = float(rng.uniform(1e-6, 1e-3))
        if i < 3 or rng.random() < 0.1:
            kw["features"] = feats[bucket]
        out.append(kw)
    return out


def _state(rec) -> dict:
    """Everything a recorder exposes, as plain data."""
    arms = {"|".join(k): (a.as_dict(), a.schedule, a.exploratory_pulls, a.stats.ewma,
                a.stats.percentile(99.0), a.stats.window_min())
            for k, a in rec.arms().items()}
    return {
        "arms": arms,
        "summary": rec.summary(),
        "calibration": rec.calibration_samples(),
        "totals": rec.calibration_totals(),
        "features": {b: rec.bucket_features(b) for b in ("b0", "b1", "b2")},
        "seq": rec.seq,
        "for_cell": sorted(rec.arms_for("b1", "latency")),
    }


def _nan_equal(a, b):
    assert json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("window", [128, 8])
def test_recorder_aggregates_equal_reference(seed, window):
    states = []
    for mod in PACKAGES:
        rec = mod.TelemetryRecorder(window=window, ewma_alpha=0.3)
        recs = [rec.observe(**kw) for kw in _stream(seed)]
        assert [r.seq for r in recs] == list(range(len(recs)))
        dropped = (rec.reset_calibration("ell"), rec.total_observations())
        rec.observe(bucket="b0", objective="latency", fmt="ell", measured_s=1e-3,
                    predicted_s=5e-4)
        states.append((_state(rec), dropped, recs[7].as_json()))
    _nan_equal(states[0], states[1])
    assert states[1][0]["totals"]["ell"] > len(states[1][0]["calibration"]["ell"]) == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_log_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    stream = _stream(3, 70)
    paths = {}
    for name, mod in (("ref", ref_recorder), ("port", recorder)):
        rec = mod.TelemetryRecorder(tmp_path / f"{name}.jsonl", flush_every=16)
        for kw in stream:
            rec.observe(**kw)
        assert rec.summary()["pending"] == 70 % 16
        rec.close()
        paths[name] = tmp_path / f"{name}.jsonl"
    # the same records give the same bytes: the log format is shared
    assert paths["ref"].read_bytes() == paths["port"].read_bytes()
    reader = recorder if writer == "ref" else ref_recorder
    replayed = reader.TelemetryRecorder(paths[writer])
    written = PACKAGES[writer == "port"].TelemetryRecorder(paths[writer])
    _nan_equal(_state(replayed), _state(written))
    assert replayed.total_observations() == 70 and replayed.seq == 70


def test_replay_after_a_torn_line_equal(tmp_path):
    results = []
    for mod in PACKAGES:
        path = tmp_path / f"{mod.__name__}.jsonl"
        rec = mod.TelemetryRecorder(path, flush_every=4)
        for kw in _stream(4, 12):
            rec.observe(**kw)
        with open(path, "a") as f:
            f.write('{"seq": 99, "bucket": "b0", "objec')  # a crash mid-append
        reborn = mod.TelemetryRecorder(path, flush_every=1)
        # the next append starts on a line of its own, the torn one is skipped
        reborn.observe(bucket="b9", objective="latency", fmt="csr", measured_s=2e-3)
        again = mod.TelemetryRecorder(path)
        results.append((_state(reborn), reborn.records_dropped, again.records_dropped,
                        again.total_observations(), again.arm("b9", "latency", "csr").stats.count))
    _nan_equal(results[0], results[1])
    assert results[1][1:] == (1, 1, 13, 1)


# ------------------------------------------------------------------ feedback
def _recorders(seed=5):
    out = []
    for mod in PACKAGES:
        rec = mod.TelemetryRecorder()
        for kw in _stream(seed, 120):
            rec.observe(**kw)
        out.append(rec)
    return out


def _record_tuple(r) -> tuple:
    return (r.matrix, r.features.dict(), r.config.fmt, r.config.schedule.as_dict(),
            r.latency, r.feasible, r.source, math.isnan(r.energy), math.isnan(r.power))


def test_feedback_records_and_dataset_export_equal(tmp_path):
    ref_rec, rec = _recorders()
    for min_pulls in (1, 3):
        a = feedback.telemetry_records(rec, min_pulls=min_pulls)
        b = ref_feedback.telemetry_records(ref_rec, min_pulls=min_pulls)
        assert [_record_tuple(r) for r in a] == [_record_tuple(r) for r in b] and a
    loop = feedback.FeedbackLoop(rec, dataset_path=tmp_path / "port.json")
    ref_loop = ref_feedback.FeedbackLoop(ref_rec, dataset_path=tmp_path / "ref.json")
    ds, ref_ds = loop.export_dataset(), ref_loop.export_dataset()
    ds, ref_ds = loop.export_dataset(ds), ref_loop.export_dataset(ref_ds)  # superseded
    assert len(ds) == len(ref_ds) and ds.meta == ref_ds.meta
    # each package reads the other's appended dataset
    crossed = (TuningDataset.load(tmp_path / "ref.json"), RefDataset.load(tmp_path / "port.json"))
    assert [_record_tuple(r) for r in crossed[0].records] == [
        _record_tuple(r) for r in crossed[1].records]


@pytest.mark.parametrize("with_base", [False, True])
def test_feedback_refit_predicts_like_the_reference(tmp_path, with_base):
    ref_rec, rec = _recorders(6)
    base = ref_base = None
    if with_base:
        ref_base = ref_collect(scale=0.0012, names=(), n_extra=2)
        ref_base.save(tmp_path / "base.json")
        base = TuningDataset.load(tmp_path / "base.json")
    cfg = feedback.FeedbackConfig(min_pulls=2, min_formats=2, label_weight=3, refit_every=50)
    ref_cfg = ref_feedback.FeedbackConfig(**dataclasses.asdict(cfg))
    loop = feedback.FeedbackLoop(rec, base_dataset=base, config=cfg)
    ref_loop = ref_feedback.FeedbackLoop(ref_rec, base_dataset=ref_base, config=ref_cfg)
    pred, ref_pred = AutoSpmvPredictor(PredictorConfig()), RefPredictor(RefPredictorConfig())
    pred.format_clf_, ref_pred.format_clf_ = {}, {}
    assert loop.maybe_refit(pred) == ref_loop.maybe_refit(ref_pred) != {}
    assert loop.refits == ref_loop.refits == 1
    assert loop.maybe_refit(pred) == ref_loop.maybe_refit(ref_pred) == {}  # gated
    probes = [random_matrix(96, d, p, seed=s) for s, (d, p) in enumerate(
        [(5.0, "fem"), (5.0, "powerlaw"), (5.0, "banded"), (12.0, "block"), (3.0, "denserows")])]
    for obj in pred.format_clf_:
        assert [pred.predict_format(extract_features(m), obj) for m in probes] == [
            ref_pred.predict_format(ref_features(m), obj) for m in probes]


# --------------------------------------------------------------- calibrate
def _stub_tuners():
    return (AutoSpMV(StubPredictor(DEFAULT_SCHEDULE, "csr"), device="cpu"),
            RefAutoSpMV(StubPredictor(REF_DEFAULT, "csr")))


def _feed_pairs(rec, seed=8):
    rng = np.random.default_rng(seed)
    for fmt, (scale, over) in {"csr": (2.0, 3e-5), "ell": (0.5, 1e-5), "sell": (3.0, 0.0)}.items():
        for _ in range(12 if fmt != "sell" else 1):
            p = float(rng.uniform(1e-5, 1e-3))
            rec.observe(bucket="b", objective="latency", fmt=fmt,
                        measured_s=over + scale * p * float(rng.uniform(0.95, 1.05)),
                        predicted_s=p)


@pytest.mark.parametrize("min_samples", [1, 2])
def test_calibrate_equals_reference_and_evicts_partitioned_plans(tmp_path, min_samples):
    ours_t, ref_t = _stub_tuners()
    ours = AutoSpmvSession(ours_t, cache_path=tmp_path / "port.json",
                           telemetry=recorder.TelemetryRecorder())
    ref = RefSession(ref_t, cache_path=tmp_path / "ref.json",
                     telemetry=ref_recorder.TelemetryRecorder())
    dense = hetero_matrix(512)
    plans = []
    for s in (ours, ref):
        _feed_pairs(s.telemetry)
        res = s.partitioned_optimize(dense, "latency")
        s.partitioned_optimize(dense, "energy")
        plans.append((res.bucket, res.mode))
        assert len(s.cache) == 2
    model = ours.calibrate(min_samples=min_samples)
    ref_model = ref.calibrate(min_samples=min_samples)
    assert model.corrections.keys() == ref_model.corrections.keys()
    assert ("sell" in model.corrections) == (min_samples == 1)
    for f, c in model.corrections.items():
        r = ref_model.corrections[f]
        assert c.samples == r.samples
        for name in ("launch_overhead_s", "latency_scale", "mean_rel_err"):
            assert getattr(c, name) == pytest.approx(getattr(r, name), rel=1e-12, abs=1e-18)
    # the partitioned plans were scored by the old model: evicted in both
    for s, (bucket, mode) in zip((ours, ref), plans):
        assert s.cache.peek(bucket, "latency", mode) is None and len(s.cache) == 0
        assert s.stats.invalidations == 2
    # no cost model on the session: the port falls back to the H100 profile
    assert model.hw is H100_SXM and ref_model.hw.name == "tpu_v5e"
    saved = json.loads((tmp_path / "port.calibration.json").read_text())
    ref_saved = json.loads((tmp_path / "ref.calibration.json").read_text())
    assert saved["hardware"] == "h100_sxm" and ref_saved["hardware"] == "tpu_v5e"
    # the port's file also names the model its corrections scale (the
    # reference-equal one here: neither session nor tuner has another)
    assert saved.pop("base") == {"model": "CostModel"}
    assert saved.keys() == ref_saved.keys() and saved["formats"].keys() == ref_saved["formats"].keys()


def test_calibration_file_autoloads_and_crosses_with_the_tpu_exception(tmp_path):
    ours_t, ref_t = _stub_tuners()
    for name, Sess, tuner, mod in (("port", AutoSpmvSession, ours_t, recorder),
                                   ("ref", RefSession, ref_t, ref_recorder)):
        s = Sess(tuner, cache_path=tmp_path / f"{name}.json", telemetry=mod.TelemetryRecorder())
        _feed_pairs(s.telemetry)
        s.calibrate()
    # a fresh session over the same cache path loads its own file
    fresh = AutoSpmvSession(ours_t, cache_path=tmp_path / "port.json")
    assert isinstance(fresh.cost_model, CalibratedCostModel)
    assert fresh.cost_model.hw is H100_SXM and set(fresh.cost_model.corrections) == {
        "csr", "ell", "sell"}
    # the reference reads the port's file (it maps unknown hardware to its TPU)
    crossed = RefCalibrated.load(tmp_path / "port.calibration.json")
    own = CalibratedCostModel.load(tmp_path / "port.calibration.json")
    assert {f: c.as_dict() for f, c in crossed.corrections.items()} == {
        f: c.as_dict() for f, c in own.corrections.items()}
    assert isinstance(RefSession(ref_t, cache_path=tmp_path / "port.json").cost_model,
                      RefCalibrated)
    # the stated difference: the port refuses the reference's tpu_v5e file
    # unless hw= is given, and a session over that cache starts uncalibrated
    with pytest.raises(ValueError, match="tpu_v5e"):
        CalibratedCostModel.load(tmp_path / "ref.calibration.json")
    forced = CalibratedCostModel.load(tmp_path / "ref.calibration.json", hw=H100_SXM)
    ref_own = RefCalibrated.load(tmp_path / "ref.calibration.json")
    assert {f: c.as_dict() for f, c in forced.corrections.items()} == {
        f: c.as_dict() for f, c in ref_own.corrections.items()}
    assert AutoSpmvSession(ours_t, cache_path=tmp_path / "ref.json").cost_model is None
    # a cost model given to the session wins over the file, in both
    given = CostModel(reference_profile())
    assert AutoSpmvSession(ours_t, cache_path=tmp_path / "port.json",
                           cost_model=given).cost_model is given
