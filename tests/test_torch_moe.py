"""The port's MoE layer (``repro_torch.models.moe``), its block kind in
``models.model``, its expert pruning in ``models.sparse_linear`` and MoE
serving, against the reference on the CPU.

Configs: ``deepseek-moe-16b`` and ``kimi-k2-1t-a32b`` reduced (d 128, 8
experts, top-2, one shared expert, a dense first layer; float32), plus a
bfloat16 variant. Parameters are the reference's ``jax.random`` draw,
carried across with ``params_from_numpy``; inputs are seeded numpy arrays.
Tolerances after scaling by max |reference|: 1e-4 in float32, 3e-2 in
bfloat16. Routing is made skewed (a few router columns scaled up) so that
the ``ell`` / ``sell`` capacities overflow and both packages must drop the
same tokens; ``tokens_per_expert`` and the SELL hot set are integer counts
with ties, where the order of ``jax.lax.top_k`` decides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import AutoSpMV as RefAutoSpMV
from repro.core import AutoSpmvSession as RefSession
from repro.kernels import ops as ref_ops
from repro.kernels.common import DEFAULT_SCHEDULE as REF_DEFAULT
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import param as ref_param
from repro.models import sparse_linear as ref_sl
from repro_torch import configs
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels import ops
from repro_torch.kernels.common import DEFAULT_SCHEDULE
from repro_torch.models import (
    block_specs,
    decode_step,
    forward,
    init_cache,
    model_specs,
    params_from_numpy,
    prefill,
)
from repro_torch.models import moe
from repro_torch.models import sparse_linear as sl
from repro_torch.train.serve import BatchedServer, Request, ServeConfig

from torch_port_helpers import assert_scaled_close

ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
DISPATCHES = ("dense", "ell", "sell")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, **kw):
    """(reference config, port config) of the reduced ``arch``."""
    return (ref_configs.get_config(arch, reduced_config=True).replace(**kw),
            configs.get_config(arch, reduced_config=True).replace(**kw))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _moe_params(ref_cfg, seed=0, skew=True):
    """The reference's MoE params and the port's copy; ``skew`` scales two
    router columns up so that routing crowds those experts."""
    ref = ref_param.init_params(ref_moe.moe_specs(ref_cfg), jax.random.PRNGKey(seed),
                                ref_cfg.param_dtype)
    if skew:
        ref["router"] = ref["router"].at[:, :2].multiply(6.0)
    return ref, _carry(ref)


def _x(cfg, B=2, T=24, seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)


class _FakePredictor:
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


def engines():
    """(port engine, reference engine): compile-time mode's CSR plan with
    the default schedule in both."""
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    port = sl.SparseInferenceEngine(AutoSpmvSession(AutoSpMV(
        _FakePredictor(DEFAULT_SCHEDULE), _FakeOverhead(), device="cpu")))
    ref = ref_sl.SparseInferenceEngine(RefSession(RefAutoSpMV(
        _FakePredictor(REF_DEFAULT), _FakeOverhead())))
    return port, ref


# -------------------------------------------------------------------- specs
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_and_block_specs_match_the_reference(arch, reduced):
    ref_cfg = ref_configs.get_config(arch, reduced_config=reduced)
    cfg = configs.get_config(arch, reduced_config=reduced)

    def flat(tree, path=""):  # {path: (shape, axes, init, scale, dtype)}
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
        return {path: dataclasses.astuple(tree)}

    assert flat(moe.moe_specs(cfg)) == flat(ref_moe.moe_specs(ref_cfg))
    assert flat(block_specs(cfg, "moe")) == flat(ref_model.block_specs(ref_cfg, "moe"))
    spec = moe.moe_specs(cfg)
    assert spec["router"].dtype == "float32"
    assert spec["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)


def test_params_from_numpy_carries_stacked_experts_and_the_float32_router():
    ref_cfg, cfg = _cfgs("deepseek-moe-16b", param_dtype="bfloat16", compute_dtype="bfloat16")
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(3),
                                ref_cfg.param_dtype)
    params = _carry(ref)
    m, ref_m = params["groups"][0]["moe"], ref["groups"][0]["moe"]
    G, E, d, f = cfg.n_groups, cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    assert m["w_gate"].shape == (G, E, d, f) and m["w_down"].shape == (G, E, f, d)
    assert m["w_up"].dtype == torch.bfloat16 and m["router"].dtype == torch.float32
    for a, b in ((m["w_up"], ref_m["w_up"]), (m["router"], ref_m["router"]),
                 (m["shared"]["w_down"], ref_m["shared"]["w_down"])):
        assert a.float().numpy().tobytes() == np.asarray(b, np.float32).tobytes()


# ------------------------------------------------------------- the MoE FFN
def test_top_k_keeps_the_reference_order_on_ties():
    rng = np.random.default_rng(0)
    for _ in range(20):
        counts = rng.integers(0, 4, size=(3, 16)).astype(np.float32)  # many ties
        vals, idx = moe._top_k(torch.from_numpy(counts), 5)
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(counts), 5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("row_of", [None, "hot"])
def test_pack_by_expert_drops_the_reference_tokens(row_of):
    rng = np.random.default_rng(4)
    E, T, K, cap = 8, 20, 2, 6
    e_flat = rng.choice(E, size=T * K, p=[0.4, 0.2] + [0.4 / 6] * 6).astype(np.int32)
    t_flat = np.repeat(np.arange(T), K).astype(np.int32)
    w_flat = rng.random(T * K).astype(np.float32)
    n_rows, ref_row, port_row = E, None, None
    if row_of == "hot":
        rank = np.full(E, -1, np.int32)
        rank[[1, 0]] = [0, 1]
        n_rows, ref_row, port_row = 2, jnp.asarray(rank), torch.from_numpy(rank).long()
    idx, wgt = moe._pack_by_expert(torch.from_numpy(e_flat).long(),
                                   torch.from_numpy(t_flat).long(),
                                   torch.from_numpy(w_flat), n_rows, cap, row_of=port_row)
    ref_idx, ref_wgt = ref_moe._pack_by_expert(jnp.asarray(e_flat), jnp.asarray(t_flat),
                                               jnp.asarray(w_flat), n_rows, cap, row_of=ref_row)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(wgt.numpy(), np.asarray(ref_wgt))
    assert int((e_flat == 0).sum()) > cap  # the crowded expert overflowed


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_the_reference(arch, dispatch):
    ref_cfg, cfg = _cfgs(arch, dispatch_format=dispatch)
    ref, params = _moe_params(ref_cfg)
    x = _x(cfg)
    y, aux, tpe = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    ref_y, ref_aux, ref_tpe = ref_moe.moe_ffn(ref, jnp.asarray(x), ref_cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert_scaled_close(y.numpy(), np.asarray(ref_y), TOL["float32"])
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(ref_tpe))
    if dispatch != "dense":  # skewed routing overflowed a capacity: tokens dropped
        dense, _, _ = moe.moe_ffn(params, torch.from_numpy(x),
                                  cfg.replace(dispatch_format="dense"))
        assert float((dense - y).abs().max()) > 1e-3


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_ffn_in_bfloat16_matches_the_reference(dispatch):
    ref_cfg, cfg = _cfgs("deepseek-moe-16b", dispatch_format=dispatch,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    ref, params = _moe_params(ref_cfg, seed=2)
    x = _x(cfg, T=16, seed=5)
    ref_y, ref_aux, ref_tpe = ref_moe.moe_ffn(ref, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    y, aux, tpe = moe.moe_ffn(params, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    assert_scaled_close(y.float().numpy(), np.asarray(ref_y, np.float32), TOL["bfloat16"])
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-2)
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(ref_tpe))


def test_moe_ffn_refusals_match_the_reference():
    ref_cfg, cfg = _cfgs("deepseek-moe-16b")
    _, params = _moe_params(ref_cfg, skew=False)
    x = torch.from_numpy(_x(cfg, B=1, T=4))
    with pytest.raises(ValueError, match="dispatch_format='dense'"):
        moe.moe_ffn(params, x, cfg.replace(dispatch_format="ell"), engine=object())
    with pytest.raises(ValueError, match="unknown dispatch"):
        moe.moe_ffn(params, x, cfg.replace(dispatch_format="coo"))
    big = cfg.replace(dispatch_format="dense", d_ff_expert=1 << 26)
    with pytest.raises(ValueError, match="dense dispatch"):
        moe.moe_ffn(params, x, big)


HISTOGRAMS = {
    "uniform": [6, 6, 6, 6, 6, 6, 6, 6],
    "skewed": [40, 2, 1, 0, 3, 1, 0, 1],
    "tied": [9, 9, 0, 0, 9, 0, 0, 1],
    "mild": [7, 5, 6, 8, 4, 6, 7, 5],
    "empty": [0, 0, 0, 0],
    "two-hot": [20, 20, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
}


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_select_dispatch_format_matches_the_reference(name):
    h = np.asarray(HISTOGRAMS[name], np.float32)
    pick = moe.select_dispatch_format(h)
    assert pick == ref_moe.select_dispatch_format(h)
    assert moe.select_dispatch_format(torch.from_numpy(h)) == pick
    if name == "uniform":
        assert pick == "ell"
    if name == "skewed":
        assert pick == "sell"


def test_select_dispatch_format_on_the_routing_histogram():
    ref_cfg, cfg = _cfgs("kimi-k2-1t-a32b")
    ref, params = _moe_params(ref_cfg)
    x = _x(cfg, T=32, seed=6)
    _, _, tpe = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    _, _, ref_tpe = ref_moe.moe_ffn(ref, jnp.asarray(x), ref_cfg)
    assert moe.select_dispatch_format(tpe) == ref_moe.select_dispatch_format(ref_tpe)


# ---------------------------------------------------------- whole model
def _model_params(ref_cfg, seed=0):
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(seed),
                                ref_cfg.param_dtype)
    return ref, _carry(ref)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_and_auxiliaries_match_the_reference(arch, dispatch):
    ref_cfg, cfg = _cfgs(arch, dispatch_format=dispatch)
    ref, params = _model_params(ref_cfg, seed=1)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits, aux = forward(params, cfg, tokens=torch.from_numpy(tokens))
    ref_logits, ref_aux = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens))
    assert_scaled_close(logits.numpy(), np.asarray(ref_logits), TOL["float32"])
    assert float(aux["moe_aux"]) == pytest.approx(float(ref_aux["moe_aux"]), rel=1e-5)
    np.testing.assert_array_equal(aux["tokens_per_expert"].numpy(),
                                  np.asarray(ref_aux["tokens_per_expert"]))
    # two MoE layers route every token top-k times each
    assert float(aux["tokens_per_expert"].sum()) == 2 * 12 * cfg.top_k * cfg.n_groups
    # prefill + one decode step through the cache
    cache = init_cache(cfg, 2, 32, "cpu")
    p_logits, cache, p_aux = prefill(params, cfg, cache, tokens=torch.from_numpy(tokens))
    ref_cache = ref_model.init_cache(ref_cfg, 2, 32)
    rp_logits, ref_cache, rp_aux = ref_model.prefill(ref, ref_cfg, ref_cache,
                                                     tokens=jnp.asarray(tokens))
    assert_scaled_close(p_logits.numpy(), np.asarray(rp_logits), TOL["float32"])
    np.testing.assert_array_equal(p_aux["tokens_per_expert"].numpy(),
                                  np.asarray(rp_aux["tokens_per_expert"]))
    nxt = p_logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((2, 1), 12, dtype=torch.int32)
    d_logits, _ = decode_step(params, cfg, cache, nxt, pos)
    rd_logits, _ = ref_model.decode_step(ref, ref_cfg, ref_cache, jnp.asarray(nxt.numpy()),
                                         jnp.asarray(pos.numpy()))
    assert_scaled_close(d_logits.numpy(), np.asarray(rd_logits), TOL["float32"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_model_logits_with_bfloat16_params_match_the_reference(dispatch):
    """bfloat16 weights (carried bit for bit) under float32 compute. In
    bfloat16 compute the two frameworks round activations at other places,
    and where a token's router probabilities nearly tie, its top-k can
    differ between them and move every later position through attention;
    bfloat16 compute is held at the layer (``moe_ffn`` above, same routing)
    and against the port's own dense dispatch on the engine path below."""
    ref_cfg, cfg = _cfgs("deepseek-moe-16b", dispatch_format=dispatch,
                         param_dtype="bfloat16", compute_dtype="float32")
    ref, params = _model_params(ref_cfg, seed=4)
    assert params["groups"][0]["moe"]["w_up"].dtype == torch.bfloat16
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    logits, aux = forward(params, cfg, tokens=torch.from_numpy(tokens))
    ref_logits, ref_aux = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens))
    assert logits.dtype == torch.float32
    assert_scaled_close(logits.numpy(), np.asarray(ref_logits), TOL["float32"])
    np.testing.assert_array_equal(aux["tokens_per_expert"].numpy(),
                                  np.asarray(ref_aux["tokens_per_expert"]))


# ------------------------------------------------ the engine (sparse) path
def _registrations(engine):
    return {n: (l.fingerprint, l.density, l.d_in, l.d_out, l.spmv_eligible, l.weight_t.tobytes())
            for n, l in engine._by_name.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_pruned_experts_registrations_and_engine_logits_match(arch):
    """The port's engine path against its own dense dispatch and the
    reference's logits on the same pruned weights (the reference's engine
    path is the same math as its dense dispatch; it is run at the layer in
    the next test, where its interpret-mode kernels stay cheap)."""
    ref_cfg, cfg = _cfgs(arch, dispatch_format="dense", n_layers=2)  # attn + one MoE layer
    ref, params = _model_params(ref_cfg, seed=6)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    regs = _registrations(port_engine)
    assert regs == _registrations(ref_engine)
    per_moe = 3 * cfg.n_experts + 3 * (cfg.n_shared_experts > 0)
    assert len(regs) == 3 + per_moe * cfg.n_groups
    assert "g0x0.moe.w_down.7" in regs and "g0x0.moe.shared.w_up" in regs
    assert pruned["groups"][0]["moe"]["w_up"].shape == (
        cfg.n_groups, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert torch.equal(pruned["groups"][0]["moe"]["router"], params["groups"][0]["moe"]["router"])

    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    handle = port_engine.bind("latency")
    sparse, aux = forward(pruned, cfg, tokens=torch.from_numpy(tokens), unroll_layers=True,
                          engine=handle)
    dense, dense_aux = forward(pruned, cfg, tokens=torch.from_numpy(tokens))
    ref_sparse, ref_aux = ref_model.forward(ref_pruned, ref_cfg, tokens=jnp.asarray(tokens))
    assert_scaled_close(sparse.numpy(), dense.numpy(), TOL["float32"])
    assert_scaled_close(sparse.numpy(), np.asarray(ref_sparse), TOL["float32"])
    np.testing.assert_array_equal(aux["tokens_per_expert"].numpy(),
                                  np.asarray(ref_aux["tokens_per_expert"]))
    assert float(aux["moe_aux"]) == pytest.approx(float(ref_aux["moe_aux"]), rel=1e-5)
    # every registered matrix ran as a planned SpMV: one plan each
    assert port_engine.stats.plans == len(regs) and port_engine.stats.dense_fallbacks == 0
    assert port_engine.session.stats.requests == len(regs)

    # one decode step: sparse against dense and the reference
    cache = init_cache(cfg, 1, 32, "cpu")
    logits, cache, _ = prefill(pruned, cfg, cache, tokens=torch.from_numpy(tokens))
    ref_cache = ref_model.init_cache(ref_cfg, 1, 32)
    _, ref_cache, _ = ref_model.prefill(ref_pruned, ref_cfg, ref_cache, tokens=jnp.asarray(tokens))
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((1, 1), 5, dtype=torch.int32)
    before = port_engine.stats.spmv_matmuls
    step, _ = decode_step(pruned, cfg, cache, nxt, pos, unroll_layers=True, engine=handle)
    step_dense, _ = decode_step(pruned, cfg, cache, nxt, pos)
    ref_step, _ = ref_model.decode_step(ref_pruned, ref_cfg, ref_cache,
                                        jnp.asarray(nxt.numpy()), jnp.asarray(pos.numpy()))
    assert port_engine.stats.spmv_matmuls - before == len(regs)
    assert_scaled_close(step.numpy(), step_dense.numpy(), TOL["float32"])
    assert_scaled_close(step.numpy(), np.asarray(ref_step), TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_engine_path_matches_the_references_engine_path(arch):
    ref_cfg, cfg = _cfgs(arch, dispatch_format="dense")
    ref, params = _moe_params(ref_cfg, seed=11)
    port_engine, ref_engine = engines()
    # one MoE layer's leaves, pruned and registered as prune_model_ffns does
    block = {"moe": params}
    ref_block = {"moe": ref}
    cfg1, ref_cfg1 = cfg.replace(n_layers=1, first_blocks=("moe",)), ref_cfg.replace(
        n_layers=1, first_blocks=("moe",))
    pruned = sl.prune_model_ffns({"head": (block,), "groups": (), "tail": ()}, cfg1,
                                 port_engine, density=0.1)["head"][0]["moe"]
    ref_pruned = ref_sl.prune_model_ffns({"head": (ref_block,), "groups": (), "tail": ()},
                                         ref_cfg1, ref_engine, density=0.1)["head"][0]["moe"]
    assert _registrations(port_engine) == _registrations(ref_engine)
    x = _x(cfg, B=1, T=2, seed=12)
    y, aux, tpe = moe.moe_ffn(pruned, torch.from_numpy(x), cfg,
                              engine=port_engine.bind("latency"), name="head0")
    ref_y, ref_aux, ref_tpe = ref_moe.moe_ffn(ref_pruned, jnp.asarray(x), ref_cfg,
                                              engine=ref_engine.bind("latency"), name="head0")
    dense, _, _ = moe.moe_ffn(pruned, torch.from_numpy(x), cfg)
    assert_scaled_close(y.numpy(), np.asarray(ref_y), TOL["float32"])
    assert_scaled_close(y.numpy(), dense.numpy(), TOL["float32"])
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(ref_tpe))
    n = 3 * cfg.n_experts + 3
    assert port_engine.stats.spmv_matmuls == n and port_engine.stats.plans == n
    assert port_engine.session.stats.requests == ref_engine.session.stats.requests == n


def test_moe_ffn_engine_path_equals_dense_dispatch_in_bfloat16():
    ref_cfg, cfg = _cfgs("deepseek-moe-16b", dispatch_format="dense", n_layers=2,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    ref, params = _model_params(ref_cfg, seed=8)
    port_engine, _ = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32))
    sparse, _ = forward(pruned, cfg, tokens=tokens, unroll_layers=True,
                        engine=port_engine.bind("latency"))
    dense, _ = forward(pruned, cfg, tokens=tokens)
    assert_scaled_close(sparse.numpy(), dense.numpy(), TOL["bfloat16"])


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


def test_batched_server_decodes_the_reference_models_greedy_tokens():
    ref_cfg, cfg = _cfgs("deepseek-moe-16b", dispatch_format="dense", n_layers=2)
    ref, params = _model_params(ref_cfg, seed=10)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).tolist()
               for _ in range(3)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    server = BatchedServer(pruned, cfg, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4),
                           engine=port_engine)
    done = server.run(reqs)
    # the reference server's slot surgery writes a layer group, not the slot
    # (ROADMAP.md queue C): the port is held against the reference model
    assert [r.generated for r in done] == [
        _ref_greedy(ref_pruned, ref_cfg, p, 4, 64) for p in prompts]
    regs = port_engine.stats.registered
    assert port_engine.stats.spmv_matmuls == regs * server.ticks
    assert server.summary()["engine"]["objectives"]["latency"]["plans"] == regs
