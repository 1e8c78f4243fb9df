"""The first slice of the port as a whole, against the reference package.

One dataset, collected by the reference and carried across as JSON, fits the
tuners of both packages; the same requests (with repeats) then go through
``repro.train.serve.SpmvServer`` (Pallas kernels in interpret mode) and the
port's (``device="cpu"``: plain PyTorch versions). Schedules, cache-hit
flags, session counts, chosen formats and ``convert`` verdicts are exact;
``y`` agrees within 1e-4 (float32 accumulation) or 3e-2 (bfloat16) after
scaling by max |ref|, the rule of ``tests/test_kernels.py``."""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.partition.executor as ref_executor
import repro.train.serve as ref_serve_module
import repro_torch.partition.executor as executor
import repro_torch.train.serve as serve_module

from repro.core import autotuner as ref_autotuner
from repro.core.cache import TuningCache as RefCache
from repro.core.dataset import collect_dataset as ref_collect
from repro.core.features import extract_features as ref_features
from repro.core.overhead import OverheadPredictor as RefOverhead
from repro.core.overhead import OverheadSample as RefOverheadSample
from repro.core.predictor import AutoSpmvPredictor as RefPredictor
from repro.core.predictor import PredictorConfig as RefPredictorConfig
from repro.core.session import AutoSpmvSession as RefSession
from repro.kernels import ops as ref_ops
from repro.obs import slo as ref_slo
from repro.obs import sync as ref_sync
from repro.obs.metrics import MetricsRegistry as RefMetricsRegistry
from repro.obs.metrics import reset_metrics as ref_reset_metrics
from repro.sparse.generate import MATRIX_NAMES, generate_by_name, random_matrix
from repro.train.serve import SpmvRequest as RefRequest
from repro.telemetry import AdaptiveFormatSelector as RefSelector
from repro.telemetry import TelemetryRecorder as RefRecorder
from repro.train.serve import SpmvServer as RefServer
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.cache import TuningCache
from repro_torch.core.dataset import TuningDataset
from repro_torch.core.features import extract_features
from repro_torch.core.objectives import CostModel
from repro_torch.core.overhead import OverheadPredictor, OverheadSample
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.session import AutoSpmvSession, ServedPlan, build_tuner
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import slo
from repro_torch.obs import sync
from repro_torch.obs.metrics import MetricsRegistry, reset_metrics
from repro_torch.obs.trace import get_tracer, load_spans
from repro_torch.telemetry import AdaptiveFormatSelector, TelemetryRecorder
from repro_torch.train.serve import SpmvRequest, SpmvServer

from torch_port_helpers import (
    FORMATS,
    assert_scaled_close,
    reference_profile,
    same_clocks,
    tol_for,
    traced,  # noqa: F401  (a fixture)
)

SCALE = 0.0015
NAMES = MATRIX_NAMES[:6]
OBJECTIVES = ("latency", "energy", "power", "efficiency")
COUNT_FIELDS = ("requests", "feature_extractions", "plans_computed",
                "kernel_compiles", "cache_hits", "cache_misses")


def _overhead(cls_pred, cls_sample, feats_fn):
    """Overhead model fit on fixed numbers, so both packages get the same
    f/c estimates (wall-clock samples would differ between two runs)."""
    samples = []
    for i, n in enumerate(NAMES):
        dense = generate_by_name(n, scale=SCALE)
        c = {f: 2e-4 * (i + 1) * (j + 1) for j, f in enumerate(FORMATS)}
        samples.append(cls_sample(n, feats_fn(dense), 1e-4 * (i + 1), c))
    return cls_pred().fit(samples)


@pytest.fixture(scope="module")
def tuners(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "dataset.json"
    ds = ref_collect(scale=SCALE, names=NAMES, n_extra=2)
    ds.save(path)
    ref_pred = RefPredictor(RefPredictorConfig(max_regressor_samples=1000)).fit(ds)
    pred = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=1000)).fit(
        TuningDataset.load(path))
    ref = ref_autotuner.AutoSpMV(ref_pred, _overhead(RefOverhead, RefOverheadSample, ref_features))
    ours = AutoSpMV(pred, _overhead(OverheadPredictor, OverheadSample, extract_features),
                    device="cpu")
    return ours, ref


@pytest.fixture()
def clean():
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    yield
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()


def _traffic(cls, objective="latency"):
    """8 requests with repeats over 4 distinct matrices."""
    order = [0, 1, 0, 2, 1, 3, 0, 2]
    mats = [generate_by_name(n, scale=SCALE) for n in MATRIX_NAMES[:3]]
    mats.append(random_matrix(280, 14.0, "powerlaw", seed=77))
    rng = np.random.default_rng(5)
    reqs = []
    for rid, i in enumerate(order):
        x = rng.normal(size=mats[i].shape[1]).astype(np.float32)
        reqs.append(cls(rid=rid, dense=mats[i], x=x, objective=objective))
    return reqs


def _counts(session):
    d = session.stats.as_dict()
    return {k: d[k] for k in COUNT_FIELDS}


@pytest.mark.parametrize("objective", ["latency", "efficiency"])
def test_served_slice_matches_reference(tuners, clean, objective):
    ours, ref = tuners
    sess, ref_sess = AutoSpmvSession(ours), RefSession(ref)
    done = SpmvServer(sess).run(_traffic(SpmvRequest, objective))
    ref_done = RefServer(ref_sess).run(_traffic(RefRequest, objective))
    assert [r.cache_hit for r in done] == [r.cache_hit for r in ref_done]
    assert [r.schedule.as_dict() for r in done] == [r.schedule.as_dict() for r in ref_done]
    assert [r.served_objective for r in done] == [objective] * 8
    assert _counts(sess) == _counts(ref_sess)
    assert _counts(sess)["requests"] == 8 and _counts(sess)["kernel_compiles"] == 4
    assert sess.cache.stats() == ref_sess.cache.stats()
    for r, rr in zip(done, ref_done):
        assert isinstance(r.y, np.ndarray) and r.y.dtype == np.float32
        tol = tol_for(r.schedule.accum_dtype)
        assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol)
        assert_scaled_close(r.y, rr.y, tol)


def test_second_batch_is_all_hits_in_both(tuners, clean):
    ours, ref = tuners
    sess, ref_sess = AutoSpmvSession(ours), RefSession(ref)
    server, ref_server = SpmvServer(sess), RefServer(ref_sess)
    server.run(_traffic(SpmvRequest))
    ref_server.run(_traffic(RefRequest))
    again, ref_again = server.run(_traffic(SpmvRequest)), ref_server.run(_traffic(RefRequest))
    assert all(r.cache_hit for r in again) and all(r.cache_hit for r in ref_again)
    assert _counts(sess) == _counts(ref_sess)
    assert _counts(sess)["kernel_compiles"] == 4  # nothing recompiled
    summary = server.summary()
    assert summary["batches"] == 2 and summary["requests"] == 16
    assert summary["latency"]["latency"]["count"] >= 16 and "csr" in summary["energy"]


@pytest.mark.parametrize("n_iterations", [10, 100_000])
def test_run_time_mode_matches_reference(tuners, clean, n_iterations):
    ours, ref = tuners
    sess, ref_sess = AutoSpmvSession(ours), RefSession(ref)
    mats = [generate_by_name(n, scale=SCALE) for n in MATRIX_NAMES[:4]]
    mats.append(random_matrix(256, 20.0, "block", seed=3))
    x = np.random.default_rng(2).normal(size=4096).astype(np.float32)
    converted = 0
    for dense in mats:
        for objective in OBJECTIVES:
            a = sess.run_time_optimize(dense, objective, n_iterations=n_iterations)
            b = ref_sess.run_time_optimize(dense, objective, n_iterations=n_iterations)
            assert (a.best_format, a.convert) == (b.best_format, b.convert)
            assert a.predicted_gain_per_iter == pytest.approx(b.predicted_gain_per_iter, rel=1e-9)
            assert a.predicted_overhead == pytest.approx(b.predicted_overhead, rel=1e-9, abs=1e-15)
            assert (a.kernel is None) == (not a.convert)
            if a.convert:
                converted += 1
                xv = x[: dense.shape[1]]
                assert_scaled_close(a.kernel(xv).numpy(), dense.astype(np.float64) @ xv, 1e-4)
                assert_scaled_close(a.kernel(xv).numpy(), np.asarray(b.kernel(xv)), 1e-4)
    assert _counts(sess) == _counts(ref_sess)
    assert sess.stats.overhead_paid_s == pytest.approx(ref_sess.stats.overhead_paid_s, rel=1e-9)
    if n_iterations > 1000:
        assert converted > 0  # the other formats' kernels are really reached


def test_optimize_many_run_mode_and_bad_mode(tuners, clean):
    ours, ref = tuners
    mats = [generate_by_name(n, scale=SCALE) for n in MATRIX_NAMES[:2]] * 2
    a = AutoSpmvSession(ours).optimize_many(mats, "latency", mode="run", n_iterations=100_000)
    b = RefSession(ref).optimize_many(mats, "latency", mode="run", n_iterations=100_000)
    assert [(r.best_format, r.convert) for r in a] == [(r.best_format, r.convert) for r in b]
    assert a[0] is a[2] and a[1] is a[3]  # duplicates share one result
    with pytest.raises(ValueError):
        AutoSpmvSession(ours).optimize_many(mats, mode="partitioned")


def test_cache_json_crosses_between_packages(tuners, clean, tmp_path):
    ours, ref = tuners
    # port -> reference
    sess = AutoSpmvSession(ours, cache_path=tmp_path / "port.json")
    SpmvServer(sess).run(_traffic(SpmvRequest))
    sess.run_time_optimize(generate_by_name(NAMES[0], scale=SCALE), "energy")
    sess.save()
    ref_sess = RefSession(ref, cache_path=tmp_path / "port.json")
    assert len(ref_sess.cache) == len(sess.cache) == 5
    warm = RefServer(ref_sess).run(_traffic(RefRequest))
    assert all(r.cache_hit for r in warm) and ref_sess.stats.plans_computed == 0
    # reference -> port
    ref_ops.clear_kernel_memo()
    cold_ref = RefSession(ref, cache_path=tmp_path / "ref.json")
    ref_done = RefServer(cold_ref).run(_traffic(RefRequest))
    cold_ref.save()
    ops.clear_kernel_memo()
    warm_sess = AutoSpmvSession(ours, cache_path=tmp_path / "ref.json")
    done = SpmvServer(warm_sess).run(_traffic(SpmvRequest))
    assert all(r.cache_hit for r in done) and warm_sess.stats.plans_computed == 0
    assert [r.schedule.as_dict() for r in done] == [r.schedule.as_dict() for r in ref_done]
    # entry for entry the same JSON schema
    a = json.loads((tmp_path / "port.json").read_text())
    b = json.loads((tmp_path / "ref.json").read_text())
    assert a["version"] == b["version"] and a["resolution"] == b["resolution"]
    assert set(a["entries"][0]) == set(b["entries"][0])
    assert {(e.bucket, e.objective, e.mode) for e in RefCache.load(tmp_path / "port.json").entries()} >= {
        (e.bucket, e.objective, e.mode) for e in TuningCache.load(tmp_path / "ref.json").entries()}


def test_corrupt_cache_degrades_to_cold_start(tuners, tmp_path):
    ours, _ = tuners
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    assert len(AutoSpmvSession(ours, cache_path=path).cache) == 0


class _Recorder:
    """Duck-typed telemetry recorder, as the session expects one."""

    def __init__(self):
        self.seen = []

    def observe(self, **kw):
        self.seen.append(kw)

    def summary(self):
        return {"observations": len(self.seen)}


def test_observed_path_feeds_measurements_back(tuners, clean):
    ours, _ = tuners
    rec = _Recorder()
    sess = AutoSpmvSession(ours, telemetry=rec)
    server = SpmvServer(sess)
    assert server.adaptive  # a recorder switches the observed path on
    done = server.run(_traffic(SpmvRequest))
    assert len(rec.seen) == 8 and sess.stats.observations == 8
    assert {o["fmt"] for o in rec.seen} == {"csr"} and all(o["measured_s"] > 0 for o in rec.seen)
    assert [r.cache_hit for r in done] == [False, False, True, False, True, False, True, True]
    assert server.summary()["telemetry"] == {"observations": 8}
    plan = sess.serve_optimize(done[0].dense, "latency")
    assert isinstance(plan, ServedPlan) and plan.cache_hit and plan.fmt == "csr"
    for r in done:
        assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol_for(r.schedule.accum_dtype))


def test_invalidate_and_evict_format(tuners, clean):
    ours, _ = tuners
    sess = AutoSpmvSession(ours)
    dense = generate_by_name(NAMES[1], scale=SCALE)
    res = sess.compile_time_optimize(dense, "latency")
    key = sess.plan_key(res.features, "latency")
    assert key in sess.cache
    assert sess.evict_format("csr") == 1 and key not in sess.cache
    assert sess.stats.invalidations == 1
    sess.compile_time_optimize(dense, "latency")
    assert sess.invalidate(key[0]) == 1 and sess.invalidate(key[0]) == 0
    for s in (sess, RefSession(tuners[1])):  # calibrating needs measurements
        with pytest.raises(ValueError, match="telemetry recorder"):
            s.calibrate()


# each option rests on what the launcher gives it: a recorder, a selector
def _needs(kw):
    telemetry = bool(kw.get("anomaly") or kw.get("calibrate_every") or kw.get("adaptive"))
    return telemetry, bool(kw.get("adaptive") or kw.get("fleet"))


# latency targets the same clock's times cross: classes fire, then escalate
SLO_CFG = dict(fast_window=4, slow_window=8, min_samples=2)
SLO_P99_S = 4e-4


def _server_pair(tuners, kw, tmp_path):
    """(port, reference) ``SpmvServer``s with one option of the observability
    slice, each over a fresh session holding what the option rests on. The
    port plans partitions with the reference's cost-model constants."""
    pairs = []
    for pkg, tuner in zip(("port", "ref"), tuners):
        port = pkg == "port"
        telemetry, adaptive = _needs(kw)
        Rec, Sel = (TelemetryRecorder, AdaptiveFormatSelector) if port else (RefRecorder, RefSelector)
        sess_kw = {"cost_model": CostModel(reference_profile())} if port else {}
        sess = (AutoSpmvSession if port else RefSession)(
            tuner, telemetry=Rec() if telemetry else None,
            adaptive=Sel() if adaptive else None, **sess_kw)
        server_kw = {k: v for k, v in kw.items() if k not in ("slo", "fleet")}
        slo_mod, sync_mod = (slo, sync) if port else (ref_slo, ref_sync)
        if kw.get("slo"):  # a registry of its own: the process one is shared
            registry = (MetricsRegistry if port else RefMetricsRegistry)()
            server_kw["slo"] = slo_mod.SloTracker(slo_mod.SloConfig(
                **SLO_CFG, targets={c: slo_mod.SloTarget(p99_latency_s=SLO_P99_S)
                                    for c in slo_mod.SLO_CLASSES}), registry=registry)
        if kw.get("fleet"):
            server_kw["fleet"] = sync_mod.FleetSync(sess, tmp_path / pkg, instance=pkg,
                                                    sync_every=4)
        pairs.append(((SpmvServer if port else RefServer)(sess, **server_kw),
                      SpmvRequest if port else RefRequest))
    return pairs


def _close_tree(a, b, rel=1e-9):
    """Nested dicts/lists equal, floats to ``rel``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close_tree(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close_tree(x, y, rel)
    elif isinstance(a, float) and not (math.isnan(a) and math.isnan(b)):
        assert a == pytest.approx(b, rel=rel, abs=1e-300)
    else:
        assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


def _partition_tol(server, dense) -> float:
    res = server.session.partitioned_optimize(dense, "latency", max_blocks=server.max_blocks)
    return max(tol_for(b.schedule.accum_dtype) for b in res.plan.blocks)


@pytest.mark.parametrize("kw", [dict(partition=True, adaptive=True),
                                dict(partition=True, fused=True, adaptive=True), dict(anomaly=True),
                                dict(slo=True), dict(fleet=True),
                                dict(calibrate_every=4)])
def test_later_slices_raise_not_implemented(tuners, clean, kw, monkeypatch, tmp_path):
    """The server options of the observability slice, each served through
    both packages on the same clock and held against the reference: served
    formats and objectives, bandit and telemetry arms, watchdog, SLO,
    fleet and calibration state, and every ``y``."""
    reset_metrics()
    ref_reset_metrics()
    same_clocks(monkeypatch, serve_module, ref_serve_module, executor, ref_executor)
    (server, Req), (ref_server, RefReq) = _server_pair(tuners, kw, tmp_path)
    batches = []
    for _ in range(2):
        reqs, ref_reqs = _traffic(Req), _traffic(RefReq)
        if kw.get("slo"):
            for i, (r, rr) in enumerate(zip(reqs, ref_reqs)):
                r.slo = rr.slo = slo.SLO_CLASSES[i % len(slo.SLO_CLASSES)]
        batches.append((server.run(reqs), ref_server.run(ref_reqs)))
    for done, ref_done in batches:
        assert [(r.fmt, r.exploratory, r.cache_hit, r.served_objective) for r in done] == [
            (r.fmt, r.exploratory, r.cache_hit, r.served_objective) for r in ref_done]
    sess, ref_sess = server.session, ref_server.session
    assert _counts(sess) == _counts(ref_sess)
    assert sess.stats.explorations == ref_sess.stats.explorations
    summary, ref_summary = server.summary(), ref_server.summary()
    for key in ("telemetry", "adaptive", "calibrations", "slo", "anomaly"):
        assert (key in summary) == (key in ref_summary), key
        if key in summary:
            _close_tree(summary[key], ref_summary[key], rel=1e-6)
    if kw.get("adaptive"):  # per-(block, format) arms in the partitioned cases
        assert sess.telemetry.arms().keys() == ref_sess.telemetry.arms().keys()
        assert all("#blk" in k[0] for k in sess.telemetry.arms())
        assert sess.adaptive.cells().keys() == ref_sess.adaptive.cells().keys()
    if kw.get("slo"):
        fired = [r.served_objective for r, _ in zip(*batches[1])
                 if r.served_objective != r.objective]
        assert fired  # a firing class escalated its requests
    if kw.get("anomaly"):
        assert server.anomaly_fires == ref_server.anomaly_fires
    if kw.get("calibrate_every"):
        assert server.calibrations == ref_server.calibrations == 2  # once per batch
        cal, ref_cal = sess.cost_model.corrections, ref_sess.cost_model.corrections
        assert cal.keys() == ref_cal.keys() and cal
        for f in cal:
            _close_tree(cal[f].as_dict(), ref_cal[f].as_dict(), rel=1e-9)
        assert sess.cost_model.hw.name == ref_sess.cost_model.hw.name == "tpu_v5e"
    if kw.get("fleet"):
        a, b = summary["fleet"], ref_summary["fleet"]
        assert {k: v for k, v in a.items() if k not in ("fleet_dir", "instance")} == {
            k: v for k, v in b.items() if k not in ("fleet_dir", "instance")}
        assert a["syncs"] == 2  # once per batch of 8 at sync_every=4
    for done, ref_done in batches:  # after the counts: the tolerance re-plans
        for r, rr in zip(done, ref_done):
            tol = (_partition_tol(server, r.dense) if kw.get("partition")
                   else tol_for(r.schedule.accum_dtype))
            assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol)
            assert_scaled_close(r.y, rr.y, tol)


def test_slo_request_and_metrics_endpoint_raise(tuners, clean):
    """An SLO-classed request without a tracker runs under its class's
    native objective in both packages; ``start_metrics_server`` serves
    ``/metrics`` and answers ``/slo`` with 404 when no tracker is attached,
    as the reference's endpoint does."""
    ours, ref = tuners
    server, ref_server = SpmvServer(AutoSpmvSession(ours)), RefServer(RefSession(ref))
    req, ref_req = _traffic(SpmvRequest)[0], _traffic(RefRequest)[0]
    req.slo = ref_req.slo = "balanced"
    assert server.run([req])[0].served_objective == ref_server.run([ref_req])[0].served_objective \
        == "efficiency"
    bodies = []
    for srv in (server, ref_server):
        http = srv.start_metrics_server(0)
        try:
            assert srv.start_metrics_server(0) is http  # one endpoint per server
            with urllib.request.urlopen(f"{http.url}/metrics", timeout=10) as resp:
                bodies.append(resp.read().decode())
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{http.url}/slo", timeout=10)
            assert err.value.code == 404
        finally:
            srv.stop_metrics_server()
    for body in bodies:
        assert 'spmv_request_latency_seconds' in body and 'objective="efficiency"' in body


def test_dump_obs_writes_shards(tuners, clean, traced, tmp_path):
    ours, _ = tuners
    get_tracer().clear()
    server = SpmvServer(AutoSpmvSession(ours))
    server.run(_traffic(SpmvRequest)[:3])
    paths = server.dump_obs(tmp_path / "obs", instance="t")
    names = {s["name"] for s in load_spans(paths["trace"])}
    assert {"session.optimize", "cache.lookup", "kernel.compile", "kernel.execute",
            "server.request"} <= names
    assert json.loads(open(paths["summary"]).read())["requests"] == 3
    assert "spmv_requests_total" in open(paths["metrics"]).read()


def test_build_tuner_and_cli_on_cpu(clean, tmp_path):
    with pytest.raises(RuntimeError):
        build_tuner(scale=SCALE, names=NAMES[:2], n_extra=0)  # no card, no device named
    cache = tmp_path / "tuning.json"
    argv = ["--spmv", "--device", "cpu", "--requests", "6", "--spmv-train-matrices", "4",
            "--spmv-cache", str(cache), "--metrics-export", str(tmp_path / "m.jsonl"),
            "--trace-export", str(tmp_path / "t.jsonl")]
    done = launch_serve.main(argv)
    assert len(done) == 6
    for r in done:
        assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol_for(r.schedule.accum_dtype))
    n_plans = len(RefCache.load(cache))  # the reference reads the CLI's cache file
    assert n_plans >= 1 and (tmp_path / "m.jsonl").exists() and (tmp_path / "t.jsonl").exists()
    again = launch_serve.main(argv)  # warm start: every plan comes from the file
    assert all(r.cache_hit for r in again)
    with pytest.raises(SystemExit):
        launch_serve.main(["--requests", "2"])  # neither --spmv nor --arch
    with pytest.raises(RuntimeError):
        launch_serve.main(["--spmv", "--requests", "2"])  # default device is the card
