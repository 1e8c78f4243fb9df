"""The harness on the CPU: its arguments and result, finding a cell's parts
by name, the bytes a call needs, the whole-window arithmetic, the refusal to
measure without a card, and ``correct`` coming out false when the timed path
is broken underneath."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench.harness.catalog import ROOT, Catalog
from bench.harness.main import Run, main, parse, run_cell
from bench.harness.profile import Profile
from bench.harness.window import Sampler, Window
from bench.harness.yardstick import spmv_call_work

CELLS = ("gene2.stream", "ffn0.decode4", "gene2.requests")
CPU = torch.device("cpu")


def _run(catalog, cell, trace=False, seed=2**40 + 17, **kw):
    return run_cell(catalog, cell, seed, 0.2, trace, CPU, time.perf_counter(), **kw)


def test_arguments():
    a = parse(["--workload", "gene2.stream", "--seed", str(2**33 + 1), "--seconds", "10",
               "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("gene2.stream", 2**33 + 1, 10.0, 1)
    assert parse(["--workload", "x", "--seed", "-5", "--seconds", "1"]).trace == 0
    with pytest.raises(SystemExit):
        parse(["--workload", "gene2.stream", "--seconds", "10"])


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    cat = Catalog.load()
    for cell in cat.cells.values():
        assert cat.config(cell) and cat.traffic(cell) and "max_rel_err" in cat.limits(cell)["check"]
        cat.module("clients", cat.traffic(cell)["client"])
        cat.module("systems", cat.config(cell)["system"])
    for m in cat.metrics:
        assert callable(cat.reader(m.name))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(catalog, cell, trace):
    result, check, _ = _run(catalog, cell, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m.name for m in catalog.metrics_for(catalog.cell(cell), trace)}
    # a CPU run has no board counter and no device time
    cpu_blind = {"spmv_uj", "avg_power_w", "kernel_us", "spmv_roofline"}
    assert want - cpu_blind <= set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert check["max_rel_err"]["value"] < 1e-6


def test_a_cell_a_configuration_a_mix_and_a_metric_added_as_files_alone(catalog):
    bench = catalog.bench_dir
    cfg = json.loads((bench / "configs" / "human_gene2.json").read_text())
    cfg["matrix"].update(n_rows=200, n_cols=200, nnz=200 * 30)
    (bench / "configs" / "tiny_rows.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "requests.json").read_text())
    mix.update(pool=8, sample_gap=4)
    (bench / "traffic" / "requests8.json").write_text(json.dumps(mix))
    (bench / "workloads" / "tiny.requests8.json").write_text('{"check": {"max_rel_err": 1e-5}}')
    (bench / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n    return run.window.steps / run.window.seconds\n")
    spec = dict(catalog.spec)
    spec["configs"] = spec["configs"] + [{"name": "tiny_rows", "source": "x", "why": "x",
                                          "file": "bench/configs/tiny_rows.json", "reduced": []}]
    spec["workloads"] = spec["workloads"] + [{"name": "tiny.requests8", "config": "tiny_rows",
                                              "traffic": "requests8", "chips": 1, "why": "x"}]
    spec["per_layer"] = spec["per_layer"] + [{
        "name": "requests_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
        "layer": "request loop", "moves": "request_p95_us", "workloads": ["tiny.requests8"]}]
    grown = Catalog(spec, bench)
    result, _, system = _run(grown, "tiny.requests8", trace=True)
    assert result["correct"] and system.shape == (200, 200)
    assert result["metrics"]["requests_per_s"]["value"] > 0
    assert len(system.pool_host) == 8


def test_the_bytes_a_call_needs_at_both_configurations(catalog):
    # human_gene2: every stored nonzero's value and column, the row pointers, x and y once
    cfg = json.loads((ROOT / "bench/configs/human_gene2.json").read_text())["matrix"]
    assert (cfg["n_rows"], cfg["nnz"]) == (14_340, 18_068_388)
    assert spmv_call_work(14_340, 14_340, 18_068_388) == (
        18_068_388 * 8 + 14_341 * 4 + 2 * 14_340 * 4, 2 * 18_068_388) == (144_719_188, 36_136_776)
    # the FFN at its published widths: each matrix once a decode step of 4 tokens
    cfg = json.loads((ROOT / "bench/configs/deepseek-moe-16b.ffn0.s50.json").read_text())
    k = round(cfg["density"] * 2048 * 10_944)
    assert k == 11_206_656
    step = (spmv_call_work(10_944, 2048, k, 4)[0] * 2 + spmv_call_work(2048, 10_944, k, 4)[0])
    assert step == 269_679_116
    # and the systems count the same from what they drew
    _, _, s = _run(catalog, "ffn0.decode4")
    d, f = 64, 96
    kk = round(0.5 * d * f)
    assert s.work == (2 * spmv_call_work(f, d, kk, 4)[0] + spmv_call_work(d, f, kk, 4)[0],
                      3 * 2 * kk * 4)
    _, _, g = _run(catalog, "gene2.stream")
    assert g.keys.size == 384 * 40
    assert g.work == spmv_call_work(384, 384, 384 * 40)


def _module(name):
    return Catalog.load().reader(name)


def test_the_whole_window_arithmetic():
    lat = list(np.arange(1, 201) * 1e-6)  # 1 .. 200 us
    w = Window("requests", seconds=10.0, steps=200_000, products=200_000, energy_j=3000.0,
               latencies_s=lat, dispatch_s=4.0)
    run = Run("c", "requests", {"setup_s": 30.0}, w, None, (1000, 10), 1)
    assert _module("spmv_us")(run) == pytest.approx(50.0)
    assert _module("spmv_uj")(run) == pytest.approx(15_000.0)  # 300 W x 50 us
    assert _module("avg_power_w")(run) == pytest.approx(300.0)
    assert _module("request_p95_us")(run) == pytest.approx(190.05)
    assert _module("request_p50_us")(run) == pytest.approx(100.5)
    assert _module("dispatch_us.requests")(run) == pytest.approx(20.0)
    assert _module("step_mfu")(run) == pytest.approx(10 * 200_000 / 10 / 67e12 * 100)
    prof = Profile(window_s=0.02, busy_s=0.015, kernel_s=0.01, steps=100)
    run = Run("c", "stream", {}, w, prof, (67_000_000, 10), 2)
    assert _module("kernel_us")(run) == pytest.approx(50.0)
    assert _module("spmv_roofline")(run) == pytest.approx(67e6 / 3.35e12 * 100 / 0.01 * 100)
    assert _module("device_idle_share.stream")(run) == pytest.approx(25.0)
    empty = Run("c", "stream", {}, Window("stream", 1.0, 0, 0, None), None, (1, 1), 1)
    for name in ("spmv_us", "spmv_uj", "request_p95_us", "kernel_us", "avg_power_w"):
        assert _module(name)(empty) is None


def test_a_dotted_metric_without_a_file_reads_as_its_base(catalog):
    metrics = catalog.bench_dir / "metrics"
    assert not (metrics / "spmv_us.later.cell.py").exists()
    w = Window("stream", seconds=2.0, steps=10, products=40, energy_j=None)
    run = Run("c", "stream", {}, w, None, (1, 1), 4)
    assert catalog.reader("spmv_us.later.cell")(run) == pytest.approx(5e4)
    (metrics / "spmv_us.later.py").write_text("def read(run):\n    return 7.0\n")
    assert catalog.reader("spmv_us.later.cell")(run) == 7.0
    assert catalog.reader("spmv_us")(run) == pytest.approx(5e4)
    with pytest.raises(FileNotFoundError):
        catalog.reader("no_such_metric.stream")


def test_the_sample_of_answers_is_drawn_from_the_seed():
    def draw(seed):
        s = Sampler(seed, 16)
        out = []
        for _ in range(50):
            out.append(s.next)
            s.advance()
        return out

    a = draw(2**35 + 1)
    assert a == draw(2**35 + 1) and a != draw(2**35 + 2)
    assert all(1 <= g < 32 for g in np.diff(a))


def test_run_refuses_to_measure_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "gene2.stream", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "bench/run.py", "--workload", "gene2.stream",
                              "--seed", "1", "--seconds", "1"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_in_a_folder_with_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "gene2.stream",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _break(monkeypatch, catalog, cell, fault):
    """Break the timed path under the harness: the system's step."""
    system_cls = catalog.module("systems", catalog.config(catalog.cell(cell))["system"]).System
    real = system_cls.step
    last = {}

    def step(self, x):
        outs = real(self, x)
        if fault == "altered":  # one answer altered where it is produced
            y = outs[0].clone()
            y.view(-1)[3] += 0.01 * y.abs().max()
            outs = (y,) + outs[1:]
        elif fault == "half_batch":  # half of the tokens left out
            outs = tuple(torch.cat([o[: o.shape[0] // 2], torch.zeros_like(o[o.shape[0] // 2:])])
                         for o in outs)
        elif fault == "stale":  # the step hands back what it held, unchanged
            outs, last["outs"] = last.get("outs", outs), outs
        return outs

    monkeypatch.setattr(catalog, "module", lambda kind, name: _Patched(
        Catalog.module(catalog, kind, name), system_cls, step))


class _Patched:
    """A module whose ``System`` has its ``step`` replaced."""

    def __init__(self, mod, system_cls, step):
        self._mod = mod
        if getattr(mod, "System", None) is not None:
            self.System = type("Broken", (mod.System,), {"step": step})

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in ("altered", "stale")]
                         + [("ffn0.decode4", "half_batch")])
def test_correct_comes_out_false_when_the_timed_path_is_broken(monkeypatch, catalog, cell, fault):
    _break(monkeypatch, catalog, cell, fault)
    result, check, _ = _run(catalog, cell)
    assert result["correct"] is False
    assert check["max_rel_err"]["value"] > check["max_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_bfloat16_accumulation_is_not_correct(catalog, cell):
    result, check, _ = _run(catalog, cell, control=True)
    assert result["correct"] is False, check
    accum = result["served"]["served_accum"]
    assert "bfloat16" in (accum if isinstance(accum, list) else [accum])
