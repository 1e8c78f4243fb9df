"""Sparse LM serving in the port against the reference, on the CPU: the
counterparts of ``tests/test_sparse_lm.py`` for dense configs.

Both packages get the same fake predictor and overhead model (the reference
tests' own), so every plan decision is the same; the port runs with
``device="cpu"`` (plain PyTorch versions of the kernels), the reference its
Pallas kernels in interpret mode. Parameters are the reference's, carried
across with ``params_from_numpy``. Tolerances: pruning, registrations and
counters exact; float32 products 1e-5 after scaling by max |ref|; sparse vs
dense decode 5e-4 absolute, as the reference test holds it."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import AutoSpMV as RefAutoSpMV
from repro.core import AutoSpmvSession as RefSession
from repro.kernels import ops as ref_ops
from repro.kernels.common import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.models import model as ref_model
from repro.models import param as ref_param
from repro.models import sparse_linear as ref_sl
from repro.optim.compress import magnitude_prune as ref_prune
from repro.sparse import generate as ref_generate
from repro.train import serve as ref_serve
from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels import ops
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_cache, params_from_numpy, prefill
from repro_torch.models import sparse_linear as sl
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import magnitude_prune
from repro_torch.sparse import generate
from repro_torch.train import serve as serve_module
from repro_torch.train.serve import BatchedServer, Request, ServeConfig

from torch_port_helpers import assert_scaled_close, same_clocks

COUNTS = ("requests", "feature_extractions", "plans_computed", "kernel_compiles",
          "cache_hits", "cache_misses")
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
             param_dtype="float32", compute_dtype="float32")


class _FakePredictor:
    """The reference tests' predictor, with the given package's schedule."""

    def __init__(self, schedule):
        self.schedule = schedule

    def predict_format(self, feats, objective):
        return "ell"

    def predict_schedule(self, feats, objective):
        return self.schedule

    def estimate_objective(self, feats, config, objective):
        return 0.5 if config.fmt == "ell" else 1.0


class _FakeOverhead:
    def total_overhead(self, feats, fmt):
        return 1e6

    def predict_c(self, feats, fmt):
        return 1.0


def engines(**kw):
    """(port engine, reference engine) over sessions with the same fakes."""
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    port = sl.SparseInferenceEngine(AutoSpmvSession(AutoSpMV(
        _FakePredictor(DEFAULT_SCHEDULE), _FakeOverhead(), device="cpu")), **kw)
    ref = ref_sl.SparseInferenceEngine(RefSession(RefAutoSpMV(
        _FakePredictor(REF_DEFAULT), _FakeOverhead())), **kw)
    return port, ref


def _cfgs(name):
    if name == "qwen3-reduced":
        return (ref_configs.get_config("qwen3-0.6b", reduced_config=True),
                configs.get_config("qwen3-0.6b", reduced_config=True))
    return RefModelConfig(**_TINY), ModelConfig(**_TINY)


def _params(ref_cfg, seed=0):
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(seed),
                                ref_cfg.param_dtype)
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")


def _np(tree):
    return tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def sparse_weight(d_in, d_out, density=0.1, seed=0):
    w = np.random.default_rng(seed).normal(size=(d_in, d_out)).astype(np.float32)
    return ref_prune(w, density)[0]


def _registrations(engine):
    return {n: (l.fingerprint, l.density, l.d_in, l.d_out, l.spmv_eligible, l.weight_t.tobytes())
            for n, l in engine._by_name.items()}


# ------------------------------------------------------------------ pruning
@pytest.mark.parametrize("density", [0.0, 0.05, 0.37, 1.0, 1.5])
def test_magnitude_prune_bit_exact(density):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    w[3, :10] = 0.5  # ties at one magnitude: the earlier flat index wins
    w[7, :10] = -0.5
    w[9, 5:15] = 0.0
    got, got_d = magnitude_prune(w, density)
    want, want_d = ref_prune(w, density)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes() and got_d == want_d
    empty, d0 = magnitude_prune(np.zeros((0, 3)), 0.5)
    assert empty.size == 0 and d0 == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_magnitude_prune_selection_matches_the_reference_sort(seed):
    """The port selects the k-th magnitude in linear time; the reference
    sorts. Integer-valued weights (many ties), signed zeros and NaNs (last
    in the sort) must keep the same entries, bit for bit."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-3, 4, size=(30, 17)).astype(np.float32) * 0.5
    w[rng.random(w.shape) < 0.1] = -0.0
    if seed % 2:
        w[rng.random(w.shape) < 0.2] = np.nan
    for density in (0.02, 0.1, 0.5, 0.83, 0.999):
        got, got_d = magnitude_prune(w, density)
        want, want_d = ref_prune(w, density)
        assert got.tobytes() == want.tobytes() and got_d == want_d


def test_prunedffn_suite_matrix_matches_the_reference():
    assert "pruned-ffn" in generate.SUITE and "pruned-ffn" not in generate.MATRIX_NAMES
    a = generate.generate_by_name("pruned-ffn", scale=0.01)
    b = ref_generate.generate_by_name("pruned-ffn", scale=0.01)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["qwen3-reduced", "tiny"])
def test_prune_model_ffns_leaves_and_registrations_match(name):
    ref_cfg, cfg = _cfgs(name)
    ref, params = _params(ref_cfg)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    flat = jax.tree_util.tree_leaves_with_path(_np(pruned))
    want = dict((jax.tree_util.keystr(p), a)
                for p, a in jax.tree_util.tree_leaves_with_path(_np(ref_pruned)))
    assert len(flat) == len(want)
    for path, a in flat:
        b = want[jax.tree_util.keystr(path)]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    assert pruned["groups"][0]["mlp"]["w_up"].device.type == "cpu"
    assert isinstance(pruned["groups"][0]["mlp"]["w_up"], torch.Tensor)
    assert _registrations(port_engine) == _registrations(ref_engine)
    assert port_engine.stats.as_dict() == ref_engine.stats.as_dict()
    assert port_engine.stats.registered == 3 * cfg.n_layers
    assert sl.ffn_block_names(cfg) == ref_sl.ffn_block_names(ref_cfg)


# ----------------------------------------------------------- the engine
def test_slo_maps_and_registration_match():
    assert sl.SLO_OBJECTIVES == ref_sl.SLO_OBJECTIVES
    assert sl.SLO_PRIORITY == ref_sl.SLO_PRIORITY
    with pytest.raises(ValueError, match="unknown SLO class"):
        sl.slo_objective("best-effort")
    port, ref = engines(density_threshold=0.5)
    for e in (port, ref):
        e.register("a", sparse_weight(64, 96, density=0.1))
        e.register("b", np.ones((8, 8), np.float32))
        e.register("c", np.zeros((8, 8), np.float32))
        e.register("a", sparse_weight(64, 96, density=0.1))
        with pytest.raises(ValueError, match="2-D"):
            e.register("d", np.zeros((2, 2, 2), np.float32))
    port.register("t", torch.from_numpy(sparse_weight(16, 24, seed=3)))  # tensors too
    ref.register("t", sparse_weight(16, 24, seed=3))
    assert _registrations(port) == _registrations(ref)
    assert port.stats.as_dict() == ref.stats.as_dict() == dict(
        ref.stats.as_dict(), registered=4, spmv_layers=2)


def test_matmul_matches_reference_including_fallbacks():
    port, ref = engines(max_spmv_tokens=4)
    w = sparse_weight(64, 96, density=0.1)
    port.register("lin", w)
    ref.register("lin", w)
    x = np.random.default_rng(1).normal(size=(1, 3, 64)).astype(np.float32)
    wt = torch.from_numpy(w)
    y = port.matmul("lin", torch.from_numpy(x), wt, "latency")
    y_ref = np.asarray(ref.matmul("lin", jnp.asarray(x), jnp.asarray(w), "latency"))
    assert y.shape == (1, 3, 96) and y.dtype == torch.float32
    assert_scaled_close(y.numpy(), y_ref, 1e-5)
    assert_scaled_close(y.numpy(), x.astype(np.float64) @ w, 1e-5)
    # unregistered name: dense contraction, no plan, no fallback counter
    for e, xx, ww in ((port, torch.from_numpy(x), wt), (ref, jnp.asarray(x), jnp.asarray(w))):
        e.matmul("other", xx, ww, "latency")
    # token count above the SpMV window: dense fallback, counted, no new plan
    big = np.concatenate([x, x], axis=1)
    y_big = port.matmul("lin", torch.from_numpy(big), wt, "latency")
    ref.matmul("lin", jnp.asarray(big), jnp.asarray(w), "latency")
    assert_scaled_close(y_big.numpy(), big.astype(np.float64) @ w, 1e-5)
    # a bf16 activation goes through the kernel in float32 and comes back bf16
    yb = port.matmul("lin", torch.from_numpy(x).to(torch.bfloat16), wt, "latency")
    assert yb.dtype == torch.bfloat16
    ref.matmul("lin", jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), "latency")
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.dense_fallbacks == 1 and port.stats.spmv_matmuls == 2
    assert port.session.stats.requests == ref.session.stats.requests == 1


def test_plan_amortization_per_fingerprint_and_objective():
    port, ref = engines()
    w = sparse_weight(32, 48, density=0.2, seed=2)
    for e in (port, ref):
        e.register("a", w)
        e.register("a_twin", w.copy())  # same bytes -> same fingerprint
    for _ in range(3):
        for name in ("a", "a_twin"):
            port.matmul(name, torch.ones((1, 32)), torch.from_numpy(w), "latency")
            ref.matmul(name, jnp.ones((1, 32)), jnp.asarray(w), "latency")
    assert port.session.stats.requests == ref.session.stats.requests == 1
    port.matmul("a", torch.ones((1, 32)), torch.from_numpy(w), "energy")
    ref.matmul("a", jnp.ones((1, 32)), jnp.asarray(w), "energy")
    assert port.session.stats.requests == ref.session.stats.requests == 2
    assert port.summary() == ref.summary()
    for obj in ("latency", "energy"):
        assert port.format_mix(obj) == ref.format_mix(obj) == "csr"
        m, r = port.modeled_objectives(obj), ref.modeled_objectives(obj)
        assert m.keys() == r.keys() and all(m[k] == pytest.approx(r[k]) for k in m)


def test_fp32_recompile_of_a_bf16_plan():
    port, ref = engines()
    bf16 = DEFAULT_SCHEDULE.replace(accum_dtype="bfloat16")
    port.session.tuner.predictor.schedule = bf16
    ref.session.tuner.predictor.schedule = REF_DEFAULT.replace(accum_dtype="bfloat16")
    w = sparse_weight(40, 56, density=0.2, seed=5)
    for e in (port, ref):
        e.register("w", w)
        assert e.plan_all("latency") == 1
    served, kernel = port.plan("w", "latency")
    assert served.schedule.accum_dtype == "bfloat16"
    assert kernel.schedule.accum_dtype == "float32" and kernel.device.type == "cpu"
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.fp32_recompiles == 1
    x = np.random.default_rng(2).normal(size=(1, 2, 40)).astype(np.float32)
    y = port.matmul("w", torch.from_numpy(x), torch.from_numpy(w), "latency")
    assert_scaled_close(y.numpy(), x.astype(np.float64) @ w, 1e-5)  # float32, not bf16


# ------------------------------------------------------------- model path
@pytest.mark.parametrize("name", ["qwen3-reduced", "tiny"])
def test_sparse_decode_matches_dense_and_the_reference(name):
    ref_cfg, cfg = _cfgs(name)
    ref, params = _params(ref_cfg)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    cache = init_cache(cfg, 1, 32, "cpu")
    logits, cache, _ = prefill(pruned, cfg, cache, tokens=torch.from_numpy(tokens))
    ref_cache = ref_model.init_cache(ref_cfg, 1, 32)
    ref_logits, ref_cache, _ = ref_model.prefill(ref_pruned, ref_cfg, ref_cache,
                                                 tokens=jnp.asarray(tokens))
    assert_scaled_close(logits.numpy(), np.asarray(ref_logits), 1e-5)
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((1, 1), 5, dtype=torch.int32)
    dense, _ = decode_step(pruned, cfg, cache, nxt, pos)
    handle = port_engine.bind("latency")
    sparse, cache_s = decode_step(pruned, cfg, cache, nxt, pos, unroll_layers=True,
                                  engine=handle)
    assert float((dense - sparse).abs().max()) < 5e-4
    ref_sparse, ref_cache_s = ref_model.decode_step(
        ref_pruned, ref_cfg, ref_cache, jnp.asarray(nxt.numpy()), jnp.asarray(pos.numpy()),
        unroll_layers=True, engine=ref_engine.bind("latency"))
    assert_scaled_close(sparse.numpy(), np.asarray(ref_sparse), 1e-5)
    # one serve_optimize per distinct weight matrix for the whole decode
    n = 3 * cfg.n_layers
    assert port_engine.session.stats.requests == ref_engine.session.stats.requests == n
    for _ in range(2):
        nxt = sparse[:, -1:].argmax(-1).to(torch.int32)
        pos = pos + 1
        sparse, cache_s = decode_step(pruned, cfg, cache_s, nxt, pos, unroll_layers=True,
                                      engine=handle)
    assert port_engine.session.stats.requests == n
    assert port_engine.stats.spmv_matmuls == 3 * n and port_engine.stats.dense_fallbacks == 0


# ------------------------------------------------------------ serving layer
def _ref_greedy(params, cfg, prompt, n_new, max_len):
    """One request's greedy tokens by the reference model, batch of one."""
    cache = ref_model.init_cache(cfg, 1, max_len)
    logits, cache, _ = ref_model.prefill(params, cfg, cache,
                                         tokens=jnp.asarray([prompt], jnp.int32))
    out = [int(jnp.argmax(logits[0, -1]))]
    while len(out) < n_new:
        pos = jnp.asarray([[len(prompt) + len(out) - 1]], jnp.int32)
        logits, cache = ref_model.decode_step(params, cfg, cache,
                                              jnp.asarray([[out[-1]]], jnp.int32), pos)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


def test_batched_server_matches_reference_tokens_and_counters():
    ref_cfg, cfg = _cfgs("qwen3-reduced")
    ref, params = _params(ref_cfg, seed=1)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    sc = dict(batch_slots=2, max_len=64, max_new_tokens=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).tolist()
               for _ in range(3)]
    slos = ["latency-critical", "energy-saving", "balanced"]
    port_reqs = [Request(rid=i, prompt=p, max_new_tokens=4, slo=s)
                 for i, (p, s) in enumerate(zip(prompts, slos))]
    ref_reqs = [ref_serve.Request(rid=i, prompt=p, max_new_tokens=4, slo=s)
                for i, (p, s) in enumerate(zip(prompts, slos))]
    server = BatchedServer(pruned, cfg, ServeConfig(**sc), engine=port_engine)
    ref_server = ref_serve.BatchedServer(ref_pruned, ref_cfg, ref_serve.ServeConfig(**sc),
                                         engine=ref_engine)
    done = server.run(port_reqs)
    ref_done = ref_server.run(ref_reqs)
    # the tokens are each request's own greedy decode by the reference model
    # (the reference server's slot surgery writes a layer group instead of
    # the slot, so its tokens are not: ROADMAP.md queue C)
    assert [r.generated for r in done] == [
        _ref_greedy(ref_pruned, ref_cfg, p, 4, 64) for p in prompts]
    assert all(len(r.generated) == 4 and r.done for r in done)
    assert all(len(r.generated) == 4 and r.done for r in ref_done)
    s, r =server.summary(), ref_server.summary()
    for key in ("requests", "ticks", "slo_classes"):
        assert s[key] == r[key], key
    # the reference counts matmuls when jit traces a decode graph (once per
    # objective); the port runs eagerly and counts every executed call
    port_stats, ref_stats = s["engine"].pop("stats"), r["engine"].pop("stats")
    assert s["engine"] == r["engine"]
    assert port_stats.pop("spmv_matmuls") == 6 * s["ticks"]
    assert ref_stats.pop("spmv_matmuls") == 6 * len(r["engine"]["objectives"])
    assert port_stats == ref_stats
    assert {k: s["session"][k] for k in COUNTS} == {k: r["session"][k] for k in COUNTS}
    assert s["energy"].keys() == r["energy"].keys()
    assert all(s["energy"][k]["requests"] == r["energy"][k]["requests"] for k in s["energy"])
    assert {k.split("/")[1] for k in s["energy"]} == {"latency", "energy", "efficiency"}
    assert s["tick_latency"].keys() == r["tick_latency"].keys()


def test_batched_server_admit_writes_the_slot():
    """Slot surgery writes the prefilled cache into the batch slot: axis 0 of
    head/tail leaves, axis 1 of the group-stacked ones; the other slot keeps
    its contents."""
    ref_cfg, cfg = _cfgs("qwen3-reduced")
    _, params = _params(ref_cfg)
    server = BatchedServer(params, cfg, ServeConfig(batch_slots=2, max_len=64,
                                                    max_new_tokens=2))
    server.cache = tree_map(lambda c: c.normal_(), server.cache)  # tell slots apart
    before = _np(server.cache)
    prompt = [5, 6, 7, 8, 9]
    server._admit(Request(rid=0, prompt=prompt, max_new_tokens=2), 1)
    _, pc, _ = prefill(params, cfg, init_cache(cfg, 1, 64, "cpu"),
                       tokens=torch.tensor([prompt], dtype=torch.int32))
    after, want = _np(server.cache), _np(pc)
    for part, axis in (("head", 0), ("groups", 1), ("tail", 0)):
        for a, b, w in zip(tree_leaves(after[part]), tree_leaves(before[part]),
                           tree_leaves(want[part])):
            np.testing.assert_array_equal(np.take(a, 1, axis), np.take(w, 0, axis))
            np.testing.assert_array_equal(np.take(a, 0, axis), np.take(b, 0, axis))
    assert server.slot_pos[1] == len(prompt) and server.slot_req[0] is None


def test_batched_server_dense_and_refusals():
    ref_cfg, cfg = _cfgs("tiny")
    ref, params = _params(ref_cfg)
    sc = dict(batch_slots=2, max_len=32, max_new_tokens=3)
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=3) for i in range(3)]
    ref_reqs = [ref_serve.Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=3)
                for i in range(3)]
    server = BatchedServer(params, cfg, ServeConfig(**sc))
    server.run(reqs)
    ref_serve.BatchedServer(ref, ref_cfg, ref_serve.ServeConfig(**sc)).run(ref_reqs)
    assert [r.generated for r in reqs] == [_ref_greedy(ref, ref_cfg, r.prompt, 3, 32)
                                          for r in reqs]
    assert [len(r.generated) for r in ref_reqs] == [3, 3, 3]
    assert server.summary() == {"requests": 3, "ticks": server.ticks, "slo_classes": {}}
    engine, _ = engines()
    pruned = sl.prune_model_ffns(params, cfg, engine, density=0.1)
    srv = BatchedServer(pruned, cfg, ServeConfig(**sc), engine=engine)
    with pytest.raises(ValueError, match="unknown SLO class"):
        srv.run([Request(rid=0, prompt=[1, 2], max_new_tokens=1, slo="asap")])
    # with an SLO tracker: each slot's share of a dense tick feeds its
    # class's burn windows, on the same clock in both packages
    from repro.obs import slo as ref_slo
    from repro.obs.metrics import MetricsRegistry as RefMetricsRegistry
    from repro_torch.obs import slo
    from repro_torch.obs.metrics import MetricsRegistry

    clocks = pytest.MonkeyPatch()
    try:
        same_clocks(clocks, serve_module, ref_serve)
        trackers = []
        for mod, Server, Req, Conf, p, c in (
                (slo, BatchedServer, Request, ServeConfig, params, cfg),
                (ref_slo, ref_serve.BatchedServer, ref_serve.Request, ref_serve.ServeConfig,
                 ref, ref_cfg)):
            registry = (MetricsRegistry if mod is slo else RefMetricsRegistry)()
            tracker = mod.SloTracker(mod.SloConfig(fast_window=4, slow_window=8, min_samples=2),
                                     registry=registry)
            Server(p, c, Conf(**sc), slo=tracker).run(
                [Req(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=3, slo=s)
                 for i, s in enumerate(("balanced", "energy-saving", "balanced"))])
            trackers.append(tracker.snapshot())
    finally:
        clocks.undo()
    assert trackers[0] == trackers[1]
    assert trackers[0]["classes"]["balanced"]["samples"] > 0


# -------------------------------------------------------------------- CLI
def test_cli_lm_mode_on_cpu(tmp_path):
    out = tmp_path / "summary.json"
    argv = ["--arch", "qwen3-0.6b", "--lm-sparse", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-new-tokens", "3", "--max-len", "64", "--slo", "mixed",
            "--summary-export", str(out)]
    done = launch_serve.main(argv)
    assert [len(r.generated) for r in done] == [3, 3, 3]
    assert [r.slo for r in done] == ["latency-critical", "power-capped", "balanced"]
    # the reference CLI's prompts: the same numpy stream
    rng = np.random.default_rng(0)
    vocab = configs.get_config("qwen3-0.6b", reduced_config=True).vocab_size
    assert [r.prompt for r in done] == [
        rng.integers(0, vocab, size=int(rng.integers(4, 17))).tolist() for _ in range(3)]
    summary = json.loads(out.read_text())
    assert summary["requests"] == 3
    assert summary["engine"]["registered"] == summary["engine"]["spmv_layers"] == 6
    assert summary["engine"]["objectives"]["latency"] == {"plans": 6, "formats": "csr"}
    dense = launch_serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--requests", "2",
                               "--max-new-tokens", "2", "--max-len", "32"])
    assert [len(r.generated) for r in dense] == [2, 2]
    # --slo-config: the tracker the reference would load from the same file
    from repro.obs.slo import SloConfig as RefSloConfig
    from repro_torch.obs.slo import SloConfig

    (tmp_path / "slo.json").write_text(json.dumps(
        {"fast_window": 4, "targets": {"balanced": {"p99_latency_s": 1e-6}}}))
    assert dataclasses.asdict(SloConfig.load(tmp_path / "slo.json")) == dataclasses.asdict(
        RefSloConfig.load(tmp_path / "slo.json"))
    launch_serve.main(argv + ["--slo-config", str(tmp_path / "slo.json")])
    slo_summary = json.loads(out.read_text())["slo"]
    assert slo_summary["config"]["fast_window"] == 4
    assert slo_summary["classes"]["balanced"]["targets"]["p99_latency_s"] == 1e-6
    assert sum(c["samples"] for c in slo_summary["classes"].values()) > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--requests", "1"])  # the card
    # a MoE config serves sparse with the dense dispatch forced, as the
    # reference CLI does: every expert slice and shared expert is planned
    moe_out = tmp_path / "moe.json"
    moe_done = launch_serve.main(["--arch", "deepseek-moe-16b", "--lm-sparse", "--device", "cpu",
                                  "--requests", "2", "--slots", "2", "--max-new-tokens", "2",
                                  "--max-len", "32", "--summary-export", str(moe_out)])
    assert [len(r.generated) for r in moe_done] == [2, 2]
    moe_cfg = configs.get_config("deepseek-moe-16b", reduced_config=True)
    n_moe = 3 + (3 * moe_cfg.n_experts + 3) * moe_cfg.n_groups
    engine = json.loads(moe_out.read_text())["engine"]
    assert engine["registered"] == engine["spmv_layers"] == n_moe
    assert engine["objectives"]["latency"] == {"plans": n_moe, "formats": "csr"}
