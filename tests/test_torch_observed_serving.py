"""The served paths of the observability slice, port against reference:
SLO-classed ``SpmvRequest``s and ``BatchedServer(slo=)`` escalate alike
while a class is firing, and the serve CLI runs with every telemetry and
observability flag on ``--device cpu``, warm-starts from its own log and
writes files the reference reads.

Both packages get the same fake predictor and overhead model (the
reference tests' own) and, where wall time decides, the same clock
(``same_clocks``), so every decision is compared exactly; ``y`` to 1e-4 /
3e-2 after scaling by max |ref|."""

import json

import numpy as np
import pytest

import repro.train.serve as ref_serve
from repro.core.autotuner import AutoSpMV as RefAutoSpMV
from repro.core.session import AutoSpmvSession as RefSession
from repro.kernels import ops as ref_ops
from repro.kernels.common import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.models import model as ref_model
from repro.models import param as ref_param
from repro.models import sparse_linear as ref_sl
from repro.obs import aggregate as ref_aggregate
from repro.obs import slo as ref_slo
from repro.obs.metrics import MetricsRegistry as RefMetricsRegistry
from repro.obs.metrics import reset_metrics as ref_reset_metrics
from repro.sparse.generate import random_matrix
from repro.telemetry import TelemetryRecorder as RefRecorder
from repro_torch.configs.base import ModelConfig
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels import ops
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.launch import serve as launch_serve
from repro_torch.models import params_from_numpy
from repro_torch.models import sparse_linear as sl
from repro_torch.obs import slo
from repro_torch.obs.metrics import MetricsRegistry, reset_metrics
from repro_torch.telemetry import TelemetryRecorder
from repro_torch.train import serve
from repro_torch.train.serve import BatchedServer, Request, ServeConfig, SpmvRequest, SpmvServer

from torch_port_helpers import assert_scaled_close, same_clocks, tol_for


class _FakePredictor:
    """The reference tests' corrupted prior: ELL wins on paper, CSR measures
    faster; with the given package's default schedule."""

    def __init__(self, schedule):
        self.schedule = schedule

    def predict_format(self, feats, objective):
        return "ell"

    def predict_schedule(self, feats, objective):
        return self.schedule

    def estimate_objective(self, feats, config, objective):
        return 0.005 if config.fmt == "ell" else 0.02


class _FakeOverhead:
    def total_overhead(self, feats, fmt):
        return 1.0

    def predict_c(self, feats, fmt):
        return 0.5


def _tuners():
    return (AutoSpMV(_FakePredictor(DEFAULT_SCHEDULE), _FakeOverhead(), device="cpu"),
            RefAutoSpMV(_FakePredictor(REF_DEFAULT), _FakeOverhead()))


@pytest.fixture(autouse=True)
def _fresh():
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    reset_metrics()
    ref_reset_metrics()
    yield
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()


def _energy_saving_tracker(mod):
    """A tracker whose energy-saving class fires on a 1 s p99, counting in a
    registry of its own (the process registry is shared by every test)."""
    registry = (MetricsRegistry if mod is slo else RefMetricsRegistry)()
    return mod.SloTracker(mod.SloConfig(
        fast_window=4, slow_window=8, min_samples=2,
        targets={"energy-saving": mod.SloTarget(p99_latency_s=1.0)}), registry=registry)


@pytest.mark.parametrize("observed", [False, True])
def test_slo_classed_requests_escalate_alike(monkeypatch, observed):
    """An energy-saving request runs under ``energy`` until its class fires
    on latency, then under ``latency``, until the burn clears — in both
    packages, on the observed path and off it."""
    same_clocks(monkeypatch, serve, ref_serve)
    runs = []
    for pkg, tuner in zip(("port", "ref"), _tuners()):
        port = pkg == "port"
        mod = slo if port else ref_slo
        tracker = _energy_saving_tracker(mod)
        Sess, Server, Req = ((AutoSpmvSession, SpmvServer, SpmvRequest) if port else
                             (RefSession, ref_serve.SpmvServer, ref_serve.SpmvRequest))
        Rec = TelemetryRecorder if port else RefRecorder
        server = Server(Sess(tuner, telemetry=Rec() if observed else None), slo=tracker)
        dense = random_matrix(128, 6.0, "fem", seed=0)
        x = np.random.default_rng(1).normal(size=128).astype(np.float32)
        served = []
        for step in range(6):
            if step == 2:  # overload: the class's latency SLO goes to firing
                for _ in range(8):
                    tracker.observe("energy-saving", latency_s=5.0)
                tracker.evaluate()
            if step == 4:  # recovery flushes the fast window
                for _ in range(4):
                    tracker.observe("energy-saving", latency_s=1e-4)
                tracker.evaluate()
            done = server.run([Req(rid=step, dense=dense, x=x, slo="energy-saving"),
                               Req(rid=10 + step, dense=dense, x=x, slo="balanced")])
            served.append([(r.served_objective, r.fmt) for r in done])
            for r in done:
                assert_scaled_close(r.y, dense.astype(np.float64) @ x,
                                    tol_for(r.schedule.accum_dtype))
        snap = server.summary()["slo"]
        runs.append((served, snap, server.summary()["session"]["requests"]))
    assert runs[0] == runs[1]
    objectives = [s[0][0] for s in runs[0][0]]
    assert objectives == ["energy", "energy", "latency", "latency", "energy", "energy"]
    assert runs[0][1]["classes"]["energy-saving"]["alerts"] == 1


# -------------------------------------------------------------- LM server
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
             param_dtype="float32", compute_dtype="float32")


def test_batched_server_escalates_its_tick_alike(monkeypatch):
    """With a sparse engine, an energy-saving class firing on latency drags
    the ticks it leads from ``energy`` to ``latency``: both packages plan
    the same objectives and keep the same SLO state."""
    import jax

    from repro.configs.base import ModelConfig as RefModelConfig

    same_clocks(monkeypatch, serve, ref_serve)
    ref_cfg, cfg = RefModelConfig(**_TINY), ModelConfig(**_TINY)
    ref_params = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(0),
                                       ref_cfg.param_dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    sc = dict(batch_slots=2, max_len=32, max_new_tokens=3)
    runs = []
    for port in (True, False):
        mod = slo if port else ref_slo
        tuner = _tuners()[0 if port else 1]
        engine = (sl if port else ref_sl).SparseInferenceEngine(
            (AutoSpmvSession if port else RefSession)(tuner))
        pruned = (sl if port else ref_sl).prune_model_ffns(
            params if port else ref_params, cfg if port else ref_cfg, engine, density=0.1)
        tracker = _energy_saving_tracker(mod)
        Server, Conf, Req = ((BatchedServer, ServeConfig, Request) if port else
                             (ref_serve.BatchedServer, ref_serve.ServeConfig, ref_serve.Request))
        server = Server(pruned, cfg if port else ref_cfg, Conf(**sc), engine=engine, slo=tracker)
        reqs = lambda: [Req(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=3,  # noqa: E731
                            slo="energy-saving") for i in range(2)]
        server.run(reqs())
        before = sorted(server.summary()["engine"]["objectives"])
        for _ in range(8):
            tracker.observe("energy-saving", latency_s=5.0)
        tracker.evaluate()
        server.run(reqs())
        summary = server.summary()
        runs.append((before, sorted(summary["engine"]["objectives"]), summary["slo"],
                     summary["requests"], summary["ticks"]))
    assert runs[0] == runs[1]
    assert runs[0][0] == ["energy"] and runs[0][1] == ["energy", "latency"]


# -------------------------------------------------------------------- CLI
def test_cli_with_every_new_flag_on_cpu(tmp_path):
    """``--telemetry-log --adaptive --refit-every --calibrate-every
    --spmv-slo mixed --anomaly --fleet-dir --sync-every --metrics-port 0
    --profile-dir`` on the CPU, twice: the second run warm-starts from the
    log, the cache and the calibration beside it; the reference reads the
    log and the fleet shard."""
    log, fleet, cache = tmp_path / "tel.jsonl", tmp_path / "fleet", tmp_path / "t.json"
    argv = ["--spmv", "--device", "cpu", "--requests", "8", "--spmv-train-matrices", "4",
            "--spmv-cache", str(cache), "--telemetry-log", str(log), "--adaptive",
            "--refit-every", "4", "--calibrate-every", "4", "--spmv-slo", "mixed",
            "--anomaly", "--fleet-dir", str(fleet), "--sync-every", "4",
            "--metrics-port", "0", "--profile-dir", str(tmp_path / "prof"),
            "--metrics-export", str(tmp_path / "m.jsonl")]
    first = launch_serve.main(argv)
    assert [r.slo for r in first] == [slo.SLO_CLASSES[i % 4] for i in range(8)]
    for r in first:
        assert_scaled_close(r.y, r.dense.astype(np.float64) @ r.x, tol_for(r.schedule.accum_dtype))
    assert (tmp_path / "prof" / "trace.json").exists()
    assert (tmp_path / "t.calibration.json").exists()
    assert json.loads((tmp_path / "t.calibration.json").read_text())["hardware"] == "h100_sxm"
    # the reference reads what the port wrote
    ref_log = RefRecorder(log)
    assert ref_log.total_observations() == 8 and ref_log.records_dropped == 0
    report = ref_aggregate.merge_shards(sorted(fleet.glob("shard-*.jsonl")))
    assert report["instances"] == ["serve"] and report["posteriors"]
    second = launch_serve.main(argv)  # warm start: log replayed, plans cached
    assert all(r.cache_hit for r in second)
    assert RefRecorder(log).total_observations() == 16
    # the flags imply what they rest on: --fleet-dir alone turns on the bandit
    alone = launch_serve.main(["--spmv", "--device", "cpu", "--requests", "4",
                               "--spmv-train-matrices", "4", "--fleet-dir", str(fleet)])
    assert len(alone) == 4 and any(r.fmt for r in alone)
