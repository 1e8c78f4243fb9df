"""The first slice of the port as a whole, against the reference package.

One dataset, collected by the reference and carried across as JSON, fits the
tuners of both packages; the same requests (with repeats) then go through
``repro.train.serve.SpmvServer`` (Pallas kernels in interpret mode) and the
port's (``device="cpu"``: plain PyTorch versions). Schedules, cache-hit
flags, session counts, chosen formats and ``convert`` verdicts are exact;
``y`` agrees within 1e-4 (float32 accumulation) or 3e-2 (bfloat16) after
scaling by max |ref|, the rule of ``tests/test_kernels.py``."""

import json

import numpy as np
import pytest

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
from repro.sparse.generate import MATRIX_NAMES, generate_by_name, random_matrix
from repro.train.serve import SpmvRequest as RefRequest
from repro.train.serve import SpmvServer as RefServer
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.cache import TuningCache
from repro_torch.core.dataset import TuningDataset
from repro_torch.core.features import extract_features
from repro_torch.core.overhead import OverheadPredictor, OverheadSample
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.session import AutoSpmvSession, ServedPlan, build_tuner
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.obs.trace import get_tracer, load_spans
from repro_torch.train.serve import SpmvRequest, SpmvServer

from torch_port_helpers import FORMATS, assert_scaled_close, tol_for

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
    for later in ("calibrate",):
        assert not hasattr(sess, later)  # later slices; no silent stand-ins


@pytest.mark.parametrize("kw", [dict(partition=True, adaptive=True),
                                dict(partition=True, fused=True, adaptive=True), dict(anomaly=True),
                                dict(slo=object()), dict(fleet=object()),
                                dict(calibrate_every=4)])
def test_later_slices_raise_not_implemented(tuners, kw):
    ours, _ = tuners
    with pytest.raises(NotImplementedError):
        SpmvServer(AutoSpmvSession(ours), **kw)


def test_slo_request_and_metrics_endpoint_raise(tuners):
    ours, _ = tuners
    server = SpmvServer(AutoSpmvSession(ours))
    req = _traffic(SpmvRequest)[0]
    req.slo = "balanced"
    with pytest.raises(NotImplementedError):
        server.run([req])
    with pytest.raises(NotImplementedError):
        server.start_metrics_server()


def test_dump_obs_writes_shards(tuners, clean, tmp_path):
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
