"""Active observability in the port against the reference: the SLO tracker
(config loading, burn rates, the ok→warning→firing machine, escalation),
the cost-model watchdog (fires, recalibration, eviction), fleet shards and
their aggregation crossing between the packages, and the HTTP scrape
surface (``/slo`` serves the same JSON).

Every stream is drawn from one seed with numpy and fed to both packages;
the trackers and the watchdog do the same float operations in both, so
states, burn rates and fires are compared exactly, fitted corrections to
1e-12 relative."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core.autotuner import AutoSpMV as RefAutoSpMV
from repro.core.session import AutoSpmvSession as RefSession
from repro.kernels.common import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.obs import aggregate as ref_aggregate
from repro.obs import anomaly as ref_anomaly
from repro.obs import http as ref_http
from repro.obs import metrics as ref_metrics
from repro.obs import slo as ref_slo
from repro.obs import sync as ref_sync
from repro.telemetry import AdaptiveFormatSelector as RefSelector
from repro.telemetry import TelemetryRecorder as RefRecorder
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.objectives import CostModel
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.obs import aggregate, anomaly, http, metrics, slo, sync
from repro_torch.telemetry import AdaptiveFormatSelector, TelemetryRecorder

from torch_port_helpers import StubPredictor, hetero_matrix, reference_profile

SLO_PACKAGES = (ref_slo, slo)


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Each package's process-wide metrics registry, emptied around a test."""
    metrics.reset_metrics()
    ref_metrics.reset_metrics()
    yield
    metrics.reset_metrics()
    ref_metrics.reset_metrics()


# ----------------------------------------------------------------------- SLO
SLO_CONFIGS = {
    "default": {},
    "tight": dict(fast_window=8, slow_window=32, min_samples=4),
    "power_only": dict(fast_window=8, slow_window=64, min_samples=4,
                       targets={"power-capped": dict(avg_power_w=100.0)}),
    "latency_energy": dict(fast_window=4, slow_window=16, min_samples=2,
                           targets={"energy-saving": dict(p99_latency_s=1e-3),
                                    "balanced": dict(p99_latency_s=2e-3,
                                                     energy_per_request_j=5e-4)}),
}


def _slo_config(mod, name):
    raw = dict(SLO_CONFIGS[name])
    if "targets" in raw:
        raw["targets"] = {c: mod.SloTarget(**t) for c, t in raw["targets"].items()}
    return mod.SloConfig(**raw)


def _slo_script(mod, name, seed):
    """Phases of healthy, overloaded and recovered traffic over the four
    classes; every step's state, burn rates and escalation."""
    rng = np.random.default_rng(seed)
    registry = (metrics if mod is slo else ref_metrics).MetricsRegistry()
    tracker = mod.SloTracker(_slo_config(mod, name), registry=registry)
    hooks = []
    tracker.on_transition(lambda *a: hooks.append(a))
    steps = []
    for phase, (lat, power, energy) in enumerate(
            [(5e-4, 50.0, 1e-4), (5e-2, 400.0, 5.0), (3.0, 900.0, 40.0), (1e-4, 10.0, 1e-5)]):
        for _ in range(40):
            cls = mod.SLO_CLASSES[int(rng.integers(4))]
            kw = dict(latency_s=lat * float(rng.uniform(0.5, 1.5)))
            if rng.random() < 0.5:
                kw["energy_j"] = energy * float(rng.uniform(0.5, 1.5))
            if rng.random() < 0.3:
                kw["power_w"] = power * float(rng.uniform(0.5, 1.5))
            tracker.observe(cls, **kw)
            if rng.random() < 0.25:
                steps.append(("eval", tracker.evaluate()))
            steps.append((cls, tracker.state(cls), tracker.burn_rates(cls),
                          tracker.effective_objective(cls)))
    gauges = sorted((g.name, g.labels, g.value)
                    for g in tracker.metrics.instruments("gauge", "slo_alert_state"))
    return steps, hooks, tracker.snapshot(), gauges


@pytest.mark.parametrize("name", sorted(SLO_CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_tracker_decides_like_the_reference(name, seed):
    ref, ours = (_slo_script(mod, name, seed) for mod in SLO_PACKAGES)
    assert ours == ref
    states = {s[1] for s in ours[0] if s[0] != "eval"}
    if name != "default":  # the default targets are far above these loads
        assert states == {"ok", "warning", "firing"} or "firing" in states


def test_slo_config_load_and_refusals_equal(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"fast_window": 4, "warn_burn": 0.5,
                                "targets": {"balanced": {"p99_latency_s": 0.01}}}))
    assert dataclasses.asdict(slo.SloConfig.load(path)) == dataclasses.asdict(
        ref_slo.SloConfig.load(path))
    assert slo.DEFAULT_TARGETS == {k: slo.SloTarget(**dataclasses.asdict(v))
                                   for k, v in ref_slo.DEFAULT_TARGETS.items()}
    for raw in ({"fast": 1}, {"targets": {"gold": {}}},
                {"targets": {"balanced": {"p50": 1.0}}}, [1, 2]):
        path.write_text(json.dumps(raw))
        for mod in SLO_PACKAGES:
            with pytest.raises(ValueError):
                mod.SloConfig.load(path)


# ------------------------------------------------------------------ watchdog
def _sessions():
    """(port, reference) sessions with recorders around the stub predictor;
    the port scores with the reference's cost-model constants."""
    return (AutoSpmvSession(AutoSpMV(StubPredictor(DEFAULT_SCHEDULE), device="cpu"),
                            telemetry=TelemetryRecorder(),
                            cost_model=CostModel(reference_profile())),
            RefSession(RefAutoSpMV(StubPredictor(REF_DEFAULT)), telemetry=RefRecorder()))


def _pairs(rng, n, scale=2.0, noise=0.03, lie=1.0):
    preds = 1e-4 * (1 + rng.random(n) * 10)
    meas = np.abs(scale * preds * (1 + noise * rng.standard_normal(n)))
    return list(zip((preds / lie).tolist(), meas.tolist()))


@pytest.mark.parametrize("config_kw", [dict(min_samples=4, sustain=2),
                                       dict(min_samples=4, sustain=2, rel_threshold=0.5),
                                       {}])
def test_watchdog_fires_and_repairs_like_the_reference(config_kw):
    runs = []
    for sess, mod in zip(_sessions(), (anomaly, ref_anomaly)):
        dog = mod.CostModelWatchdog(sess, mod.AnomalyConfig(**config_kw))
        res = sess.partitioned_optimize(hetero_matrix(256), "latency")  # a cached plan
        rng = np.random.default_rng(11)
        polls = []
        for era, lie, n in (("healthy", 1.0, 12), ("healthy", 1.0, 12), ("healthy", 1.0, 12),
                            ("lying", 100.0, 6), ("lying", 100.0, 6), ("lying", 100.0, 6),
                            ("healthy", 1.0, 12), ("healthy", 1.0, 12)):
            for fmt in ("csr", "ell"):
                for p, m in _pairs(rng, n, lie=lie if fmt == "csr" else 1.0):
                    sess.telemetry.observe(bucket="b", objective="latency", fmt=fmt,
                                           measured_s=m, predicted_s=p)
            polls.append((era, dog.poll()))
        cal = sess.calibrate(save=False).corrections
        runs.append((polls, dog.summary(), dog.recalibrations, sess.stats.invalidations,
                     sess.cache.peek(res.bucket, "latency", res.mode) is None,
                     sess.telemetry.calibration_totals(),
                     {f: c.as_dict() for f, c in cal.items()}))
    (polls, summary, *rest, cal), (ref_polls, ref_summary, *ref_rest, ref_cal) = runs
    assert polls == ref_polls and summary == ref_summary and rest == ref_rest
    assert cal.keys() == ref_cal.keys()
    for f in cal:
        for k, v in cal[f].items():
            assert v == pytest.approx(ref_cal[f][k], rel=1e-12)
    if config_kw:  # the lying era fires on csr only, and the plan is evicted
        assert any(p == ["csr"] for _, p in polls) and rest[0] >= 1 and rest[2]


def test_watchdog_and_fleet_need_their_substrates(tmp_path):
    for Sess, tuner, dog, fleet in (
            (AutoSpmvSession, AutoSpMV(StubPredictor(DEFAULT_SCHEDULE), device="cpu"),
             anomaly.CostModelWatchdog, sync.FleetSync),
            (RefSession, RefAutoSpMV(StubPredictor(REF_DEFAULT)),
             ref_anomaly.CostModelWatchdog, ref_sync.FleetSync)):
        with pytest.raises(ValueError, match="telemetry"):
            dog(Sess(tuner))
        with pytest.raises(ValueError, match="AdaptiveFormatSelector"):
            fleet(Sess(tuner), tmp_path / "f")


# --------------------------------------------------------------------- fleet
def _selector(Sel, updates):
    sel = Sel()
    for (bucket, fmt), times in updates.items():
        for t in times:
            sel.update(bucket, "latency", fmt, t)
    return sel


UPDATES_A = {("b1", "csr"): [1.0] * 3, ("b1", "ell"): [2.0], ("b2", "sell"): [0.4, 0.5]}
UPDATES_B = {("b1", "csr"): [1.1] * 5, ("b2", "bell"): [0.2] * 2}


def _recorder(Rec):
    rec = Rec()
    for i in range(70):  # more than a shard carries (64 pairs per format)
        rec.observe(bucket="b1", objective="latency", fmt="csr",
                    measured_s=2e-4 + i * 1e-6, predicted_s=1e-4)
    return rec


def test_posterior_and_calibration_lines_equal():
    for updates in (UPDATES_A, UPDATES_B):
        a = _selector(AdaptiveFormatSelector, updates)
        b = _selector(RefSelector, updates)
        a.absorb("b1", "latency", "bell", pulls=9, value=0.5)  # peer evidence: not exported
        b.absorb("b1", "latency", "bell", pulls=9, value=0.5)
        assert sync.posterior_lines(a, "x") == ref_sync.posterior_lines(b, "x")
    assert sync.calibration_lines(_recorder(TelemetryRecorder), "x") == \
        ref_sync.calibration_lines(_recorder(RefRecorder), "x")


def _strip(report: dict) -> dict:
    report = json.loads(json.dumps(report, default=float))
    report.pop("spans", None)
    return report


def test_fleet_shards_cross_and_merge_alike(tmp_path):
    """One shard from each package (metrics, posterior and calibration
    records): each package's ``merge_shards`` gives the same report, and
    the aggregation CLI writes it."""
    metrics.get_metrics().counter("spmv_requests_total", fmt="csr").inc(3)
    ref_metrics.get_metrics().counter("spmv_requests_total", fmt="csr").inc(4)
    a = sync.write_fleet_shard(tmp_path / "shard-a.jsonl", instance="a",
                               selector=_selector(AdaptiveFormatSelector, UPDATES_A),
                               recorder=_recorder(TelemetryRecorder),
                               registry=metrics.get_metrics())
    b = ref_sync.write_fleet_shard(tmp_path / "shard-b.jsonl", instance="b",
                                   selector=_selector(RefSelector, UPDATES_B),
                                   registry=ref_metrics.get_metrics())
    torn = tmp_path / "torn.jsonl"
    torn.write_text('{"kind": "counter", "name": "x", "value": 1}\n{"kind": "poste\n')
    report = aggregate.merge_shards([a, b, torn])
    assert _strip(report) == _strip(ref_aggregate.merge_shards([a, b, torn]))
    post = report["posteriors"]["b1|latency"]
    assert post["arms"]["csr"]["pulls"] == 8 and post["incumbents"] == {"a": "csr", "b": "csr"}
    assert report["counters"]['spmv_requests_total{fmt="csr"}'] == 7.0
    assert report["calibration"]["csr"]["samples"] == 64 and report["dropped_lines"] == 1
    assert aggregate.read_shard_lines([torn])[1] == ref_aggregate.read_shard_lines([torn])[1] == 1
    assert aggregate.main([str(a), str(b), "-o", str(tmp_path / "port.json")]) == 0
    assert ref_aggregate.main([str(a), str(b), "-o", str(tmp_path / "ref.json")]) == 0
    assert _strip(json.loads((tmp_path / "port.json").read_text())) == _strip(
        json.loads((tmp_path / "ref.json").read_text()))


def test_fleet_sync_between_a_port_and_a_reference_instance(tmp_path):
    """A port instance and a reference instance share one fleet directory:
    each absorbs the other's shard, promotes the fleet's measured best, and
    the merged pulls are the per-instance sums (no echo)."""
    fleet_dir = tmp_path / "fleet"
    port_sess, ref_sess = _sessions()
    port_sess.adaptive = _selector(AdaptiveFormatSelector, {("b1", "csr"): [0.001] * 4})
    ref_sess.adaptive = _selector(RefSelector, {("b1", "ell"): [0.010] * 4})
    a = sync.FleetSync(port_sess, fleet_dir, instance="port", sync_every=4)
    b = ref_sync.FleetSync(ref_sess, fleet_dir, instance="ref")
    assert a.maybe_sync(3) is None and a.maybe_sync(1)["peers"] == 0
    stats_b = b.sync()  # the reference absorbs the port's csr evidence
    assert stats_b["peers"] == 1 and stats_b["promotions"] == 1
    stats_a = a.sync()  # and the port the reference's ell arm
    assert stats_a == {"peers": 1, "arms_absorbed": 1, "promotions": 0, "dropped_lines": 0}
    for _ in range(2):  # idempotent
        a.sync()
        b.sync()
    assert port_sess.adaptive.incumbent("b1", "latency") == \
        ref_sess.adaptive.incumbent("b1", "latency") == "csr"
    assert port_sess.adaptive.cells()[("b1", "latency")].arms["ell"].absorbed_pulls == 4
    assert ref_sess.adaptive.cells()[("b1", "latency")].arms["csr"].absorbed_pulls == 4
    report = aggregate.merge_shards(sorted(fleet_dir.glob("shard-*.jsonl")))
    assert report["posteriors"]["b1|latency"]["pulls"] == 8
    assert report["posteriors"]["b1|latency"]["converged"] is True
    assert a.summary()["syncs"] == 4 and a.summary()["promotions"] == 0


# ---------------------------------------------------------------------- HTTP
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


_HTTP_LABEL = "http-endpoint-test"


def test_http_endpoints_serve_the_same_json():
    bodies = []
    for mod, http_mod, reg in ((ref_slo, ref_http, ref_metrics), (slo, http, metrics)):
        tracker = mod.SloTracker(_slo_config(mod, "power_only"), registry=reg.MetricsRegistry())
        for _ in range(8):
            tracker.observe("power-capped", latency_s=0.1, power_w=250.0)
        tracker.evaluate()
        # a label no other test records under: other test files in the same
        # process fill each package's process registry differently
        reg.get_metrics().histogram("spmv_request_latency_seconds",
                                    objective=_HTTP_LABEL).observe(1e-3)
        server = http_mod.ObsHTTPServer(slo=tracker.snapshot, extra=lambda: {"x": 1}).start()
        bare = http_mod.ObsHTTPServer().start()
        try:
            assert server.url.startswith("http://127.0.0.1:") and server.port > 0
            got = {p: _get(server.url + p) for p in ("/slo", "/healthz", "/obs", "/metrics")}
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(server.url + "/nope")
            assert err.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(bare.url + "/slo")  # no tracker attached
            assert err.value.code == 404
        finally:
            server.stop()
            bare.stop()
        bodies.append(got)
    ref, ours = bodies
    assert json.loads(ours["/slo"][2]) == json.loads(ref["/slo"][2])
    assert json.loads(ours["/slo"][2])["classes"]["power-capped"]["state"] == "firing"
    assert ours["/healthz"] == ref["/healthz"]
    assert json.loads(ours["/obs"][2])["x"] == 1
    assert ours["/metrics"][1] == ref["/metrics"][1]
    assert b"spmv_request_latency_seconds" in ours["/metrics"][2]

    def lines(body):  # the samples this test recorded (other tests in the
        # process register instruments of their own in either registry)
        return sorted(ln for ln in body.decode().splitlines()
                      if not ln.startswith("#") and f'objective="{_HTTP_LABEL}"' in ln)

    assert len(lines(ours["/metrics"][2])) == 5  # count, sum, three quantiles
    assert lines(ours["/metrics"][2]) == lines(ref["/metrics"][2])
