"""The port's tracer (``repro_torch.obs.trace``) on the served path and in
set-up: off by default and then free, spans on the profiler's clock with a
request identity, the served call's bytes, and the readers of a traced stretch
(``tools/trace_stretch.py``) on hand-built spans.

One test needs the card (``-m card``): B1 traced under a CPU + CUDA profiler,
each launch span around its ``cudaLaunchKernel`` and each call's event interval
around its kernel. No JAX here: the card test's file must not import it.
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core.objectives import ObjectiveValues
from repro_torch.core.session import AutoSpmvSession, build_tuner
from repro_torch.kernels import KernelSchedule, compile_spmv
from repro_torch.kernels.ops import clear_kernel_memo, compile_spmv_fused, stored_bytes
from repro_torch.models.sparse_linear import SparseInferenceEngine
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer, get_tracer, load_spans, tracing
from repro_torch.partition import partition_rows
from repro_torch.partition.plan import BlockPlan, CompositePlan
from repro_torch.sparse.generate import random_matrix

ROOT = Path(__file__).resolve().parents[1]
SMALL_TUNER = dict(scale=0.0008, names=("shar_te2-b3", "rim"), n_extra=0, fit_overhead=False)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_stretch", ROOT / "tools" / "trace_stretch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.fixture
def tracer_off():
    tracer = get_tracer()
    before = tracer.enabled
    tracer.enabled = False
    tracer.clear()
    yield tracer
    tracer.enabled = before


@pytest.fixture(scope="module")
def built():
    """A small CPU tuner built with the tracer on: (tuner, its set-up spans)."""
    with tracing() as tracer:
        tracer.clear()
        tuner = build_tuner(device="cpu", **SMALL_TUNER)
        spans = tracer.spans()
    return tuner, spans


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _weight(d_in=48, d_out=40, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32)
    w[rng.random(w.shape) < 0.7] = 0.0
    return w


def _fused(dense):
    sched, zero = KernelSchedule(), ObjectiveValues(0.0, 0.0, 0.0, 0.0)
    part = partition_rows(dense, 2)
    blocks = tuple(BlockPlan(b, f, sched, zero, f) for b, f in zip(part.blocks, ("csr", "ell")))
    plan = CompositePlan("latency", part, blocks, zero, zero, "csr", sched)
    return compile_spmv_fused(dense, plan, device="cpu")


def _served(route, tuner):
    """(call, expected y) of one served route on the CPU."""
    dense = random_matrix(96, 6.0, "powerlaw", seed=3).astype(np.float32)
    x = np.random.default_rng(1).normal(size=96).astype(np.float32)
    if route == "prepared":
        kernel = compile_spmv(dense, "csr", device="cpu")
        return (lambda: kernel(x)), dense @ x
    if route == "fused":
        kernel = _fused(dense)
        return (lambda: kernel(x)), dense @ x
    engine = SparseInferenceEngine(AutoSpmvSession(tuner))
    w = _weight()
    engine.register("l", w if route == "engine_spmv" else np.ones_like(w))
    xt = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 1, 48)).astype(np.float32))
    wt = torch.from_numpy(w if route == "engine_spmv" else np.ones_like(w))
    engine.plan_all("latency")
    return (lambda: engine.matmul("l", xt, wt, "latency")), (xt @ wt).numpy()


def test_a_new_tracer_starts_off_and_the_switch_restores():
    assert Tracer().enabled is False
    tracer = get_tracer()
    before = tracer.enabled
    with tracing(False):
        assert tracer.enabled is before
    with tracing():
        assert tracer.enabled is True
    assert tracer.enabled is before


@pytest.mark.parametrize("route", ["prepared", "fused", "engine_spmv", "engine_dense"])
def test_tracer_off_served_call_builds_no_span_dict_or_event(built, tracer_off, monkeypatch,
                                                              route):
    call, want = _served(route, built[0])

    def refuse(*a, **k):
        raise AssertionError("built while the tracer is off")

    monkeypatch.setattr(trace._Span, "__init__", refuse)
    monkeypatch.setattr(Tracer, "span", refuse)
    monkeypatch.setattr(Tracer, "device_span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    y = call()
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-4)
    assert tracer_off.spans() == [] and tracer_off.device_drops == 0


def test_engine_matmul_of_four_tokens_is_one_trace(built, tracer_off):
    engine = SparseInferenceEngine(AutoSpmvSession(built[0]))
    w = _weight()
    engine.register("l", w)
    _, kernel = engine.plan("l", "latency")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 1, 48)).astype(np.float32))
    with tracing() as tracer:
        y = engine.matmul("l", x, torch.from_numpy(w), "latency")
        spans = tracer.spans()
    np.testing.assert_allclose(y.numpy(), x.numpy() @ w, rtol=1e-4, atol=1e-4)
    (root,) = [s for s in spans if s["name"] == "engine.matmul"]
    calls = [s for s in spans if s["name"] == "spmv.call"]
    assert root["attrs"] == {"layer": "l", "tokens": 4, "route": "spmv"}
    assert root["parent"] is None and root["trace"] == root["id"]
    assert len(calls) == 4 and len(spans) == 5
    assert all(c["parent"] == root["id"] and c["trace"] == root["id"] for c in calls)
    mat = kernel.mat
    want = (mat.data.numel() * 4 + mat.indices.numel() * 4 + mat.indptr.numel() * 4
            + 4 * (40 + 48))
    assert stored_bytes(mat) + 4 * (40 + 48) == want
    assert all(c["attrs"] == {"fmt": "csr", "bytes": want} for c in calls)
    for s in spans:
        assert isinstance(s["start_ns"], int) and s["start_ns"] <= s["end_ns"]
        assert s["dur_s"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e9)
        assert root["start_ns"] <= s["start_ns"] and s["end_ns"] <= root["end_ns"]


def test_set_up_spans_nest(built, tracer_off):
    _, spans = built
    by_name = {s["name"]: s for s in spans}
    build = by_name["tuner.build"]
    assert build["attrs"] == {"scale": SMALL_TUNER["scale"]} and build["parent"] is None
    assert by_name["tuner.dataset"]["parent"] == build["id"]
    assert by_name["tuner.fit"]["parent"] == build["id"]
    assert "tuner.overhead" not in by_name  # fit_overhead=False
    session = AutoSpmvSession(built[0])
    dense = random_matrix(64, 5.0, "powerlaw", seed=5).astype(np.float32)
    engine = SparseInferenceEngine(session)
    with tracing() as tracer:
        session._analyze(dense)
        session._analyze(dense)
        engine.register("w", _weight())
        spans = tracer.spans()
    first, again = [s for s in spans if s["name"] == "session.analyze"]
    assert first["attrs"] == {"memo_hit": False} and again["attrs"] == {"memo_hit": True}
    kids = {s["name"] for s in spans if s["parent"] == first["id"]}
    assert kids == {"matrix.fingerprint", "features.extract"}
    assert [s["attrs"] for s in spans if s["name"] == "engine.register"] == [{"layer": "w"}]


def test_spans_per_thread_trees_and_the_jsonl_round_trip(tracer_off, tmp_path):
    tracer = Tracer(enabled=True)

    def work(tag):
        with tracer.span("outer", tag=tag):
            with tracer.span("inner"):
                time.sleep(0.001)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = tracer.spans()
    outers = {s["id"]: s for s in spans if s["name"] == "outer"}
    inners = [s for s in spans if s["name"] == "inner"]
    assert len(outers) == 3 and len(inners) == 3
    for s in inners:
        assert s["parent"] in outers and s["trace"] == s["parent"]
        assert s["thread"] == outers[s["parent"]]["thread"]
    assert abs(spans[0]["start_ns"] - time.time_ns()) < 60e9  # Unix-epoch ns
    assert tracer.export_jsonl(tmp_path / "t.jsonl") == 6
    assert load_spans(tmp_path / "t.jsonl") == spans


def test_a_record_function_inside_a_span_lies_inside_it_on_the_profilers_clock(tracer_off):
    with tracing() as tracer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracer.span("outer"):
                time.sleep(0.0002)
                with record_function("inner"):
                    time.sleep(0.0005)
                time.sleep(0.0002)
        (outer,) = tracer.spans()
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert 0 <= inner.start_ns() - outer["start_ns"] <= 1_000_000
    assert inner.end_ns() <= outer["end_ns"]


# ------------------------------------------------ readers of a traced stretch
def _stretch():
    """Two FFN-like products in one engine.matmul, then a bare call; device
    intervals 5-105 us, 125-225 us and 300-350 us (ns below)."""
    return [
        {"name": "spmv.call", "id": 2, "parent": 1, "trace": 1, "start_ns": 10_000,
         "end_ns": 40_000, "dur_s": 30e-6, "attrs": {"fmt": "csr", "bytes": 1000},
         "dev_start_ns": 5_000, "dev_end_ns": 105_000},
        {"name": "kernel.launch", "id": 3, "parent": 2, "trace": 1, "start_ns": 20_000,
         "end_ns": 30_000, "dur_s": 10e-6, "attrs": {"kernel": "csr_spmv"}},
        {"name": "spmv.call", "id": 4, "parent": 1, "trace": 1, "start_ns": 50_000,
         "end_ns": 90_000, "dur_s": 40e-6, "attrs": {"fmt": "csr", "bytes": 1000},
         "dev_start_ns": 125_000, "dev_end_ns": 225_000},
        {"name": "kernel.launch", "id": 5, "parent": 4, "trace": 1, "start_ns": 60_000,
         "end_ns": 66_000, "dur_s": 6e-6, "attrs": {"kernel": "csr_spmv"}},
        {"name": "engine.matmul", "id": 1, "parent": None, "trace": 1, "start_ns": 0,
         "end_ns": 120_000, "dur_s": 120e-6, "attrs": {"layer": "l", "tokens": 2,
                                                       "route": "spmv"}},
        {"name": "spmv.call", "id": 6, "parent": None, "trace": 6, "start_ns": 200_000,
         "end_ns": 220_000, "dur_s": 20e-6, "attrs": {"fmt": "csr", "bytes": 1000},
         "dev_start_ns": 300_000, "dev_end_ns": 350_000},
    ]


SETUP = [{"name": "tuner.dataset", "id": 2, "parent": 1, "trace": 1, "start_ns": 0,
          "end_ns": 2_000_000_000, "dur_s": 2.0},
         {"name": "tuner.build", "id": 1, "parent": None, "trace": 1, "start_ns": 0,
          "end_ns": 5_000_000_000, "dur_s": 5.0}]
# spans as the parent program wrote them: planning only, a float ts
PARENT = [{"name": "session.optimize", "id": 1, "parent": None, "ts": 1.7e9, "dur_s": 0.5},
          {"name": "kernel.compile", "id": 2, "parent": 1, "ts": 1.7e9, "dur_s": 0.1}]

READERS = {
    "served_call_us": lambda spans, **k: TOOL.served_call_us(spans, 3, **k),
    "launch_us": lambda spans, **k: TOOL.launch_us(spans, 3, **k),
    "engine_self_us": lambda spans, **k: TOOL.engine_self_us(spans, 3, **k),
    "device_gap_us": lambda spans, **k: TOOL.device_gap_us(spans, 3, **k),
    "served_bytes_ratio": lambda spans, **k: TOOL.served_bytes_ratio(spans, 3, 800.0, **k),
    "tuner_dataset_s": lambda spans, **k: TOOL.tuner_dataset_s(spans, **k),
    "idle_gaps_by_span": lambda spans, **k: TOOL.idle_gaps_by_span(spans, **k),
}
EXPECTED = {
    "served_call_us": 30.0,  # (30 + 40 + 20) us over 3 products
    "launch_us": 16 / 3,
    "engine_self_us": 50 / 3,  # 120 less its calls' 70
    "device_gap_us": 95 / 3,  # 20 + 75 us of device time outside calls
    "served_bytes_ratio": 1000 / 800,
    "tuner_dataset_s": 2.0,
    # gap 105-225 us: middle 115 us lies in engine.matmul only; 225-300: none open
    "idle_gaps_by_span": [["caller", 75e-6], ["engine.matmul", 20e-6]],
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_built_stretch(name):
    spans = SETUP if name == "tuner_dataset_s" else _stretch()
    got = READERS[name](spans)
    if name == "idle_gaps_by_span":
        assert [g[0] for g in got] == [g[0] for g in EXPECTED[name]]
        assert [g[1] for g in got] == pytest.approx([g[1] for g in EXPECTED[name]])
    else:
        assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_in_the_parent_programs_spans(name):
    assert READERS[name](PARENT) is None
    assert READERS[name]([]) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_refuses_a_stretch_with_drops(name):
    spans = SETUP if name == "tuner_dataset_s" else _stretch()
    assert READERS[name](spans, dropped=True) is None


# ------------------------------------------------------------------ the card
@pytest.mark.card
def test_b1_spans_and_events_hold_their_launches_and_kernels(card, tracer_off):
    """256 B1 calls traced under a CPU + CUDA profiler: each ``kernel.launch``
    span holds its ``cudaLaunchKernel``, each ``spmv.call``'s event interval
    holds its kernel within 5 us at each end."""
    clear_kernel_memo()
    dense = random_matrix(8192, 160.0, "fem", seed=11).astype(np.float32)
    kernel = compile_spmv(dense, "csr", KernelSchedule(), device=card)
    x = torch.randn(8192, device=card)
    want = torch.from_numpy(dense.astype(np.float64) @ x.double().cpu().numpy())
    for _ in range(8):
        kernel(x)
    torch.cuda.synchronize(card)
    calls = 256
    with tracing() as tracer:
        tracer.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                y = kernel(x)
            torch.cuda.synchronize(card)
        spans = tracer.spans()
        assert tracer.drops == 0 and tracer.device_drops == 0
    torch.testing.assert_close(y.double().cpu(), want, rtol=1e-4, atol=1e-3)
    launches = sorted((s for s in spans if s["name"] == "kernel.launch"),
                      key=lambda s: s["start_ns"])
    served = sorted((s for s in spans if s["name"] == "spmv.call"),
                    key=lambda s: s["dev_start_ns"])
    events = list(prof.profiler.kineto_results.events())
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    api = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() == cpu and e.name().startswith("cudaLaunchKernel"))
    kernels = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.device_type() == cuda and "csr" in e.name())
    assert len(launches) == len(served) == len(api) == len(kernels) == calls
    for s, (a0, a1) in zip(launches, api):
        assert s["start_ns"] <= a0 and a1 <= s["end_ns"], (s, a0, a1)
    slack = 5_000
    lead = [k0 - s["dev_start_ns"] for s, (k0, _) in zip(served, kernels)]
    tail = [s["dev_end_ns"] - k1 for s, (_, k1) in zip(served, kernels)]
    # the end event is recorded after the span's end_ns is read: no earlier on the card
    after = [s["dev_end_ns"] - s["end_ns"] for s in served]
    print(f"ns: event before its kernel min {min(lead)} median {int(np.median(lead))} "
          f"max {max(lead)}; event after its kernel min {min(tail)} "
          f"median {int(np.median(tail))} max {max(tail)}; end event after the span's "
          f"end_ns min {min(after)} median {int(np.median(after))}")
    assert min(lead) >= -slack and min(tail) >= -slack and min(after) >= -slack
    clear_kernel_memo()
