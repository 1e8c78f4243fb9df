"""The recurrent archs as whole models in the port (``models.model``
with ``models.recurrent``): ``forward`` / ``prefill`` / ``decode_step``,
sparse serving of ``recurrentgemma-2b`` through the engine, dense serving
of ``xlstm-1.3b``, ``BatchedServer`` and the LM CLI, against the reference
on the CPU. Configs, parameters, inputs and tolerances as in
tests/test_torch_recurrent.py, whose helpers this file shares."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro.models import sparse_linear as ref_sl
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    block_specs,
    decode_step,
    forward,
    init_cache,
    model_specs,
    prefill,
)
from repro_torch import configs
from repro import configs as ref_configs
from repro_torch.models import model
from repro_torch.models import sparse_linear as sl
from repro_torch.train.serve import BatchedServer, Request, ServeConfig

from test_torch_moe import engines
from test_torch_recurrent import (
    ARCHS,
    BF16_TOL,
    LOGIT_TOL,
    RG_LAYERS,
    TEACHER_TOL,
    _carry,
    _cfgs,
    _close,
    _init,
    _spec_tuples,
    _trees_close,
    _x,
)


# ------------------------------------------------------------- whole models
def _model_cfgs(arch, **kw):
    if arch == "recurrentgemma-2b":
        kw = dict(n_layers=RG_LAYERS, window=8, **kw)
    return _cfgs(arch, **kw)


def _model_params(ref_cfg, seed):
    return _init(ref_model.model_specs(ref_cfg), seed, ref_cfg.param_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_the_reference(arch):
    """12 prompt tokens (the recurrentgemma window is 8: prefill and decode
    wrap the ring), then 4 decode steps; logits and every cache leaf.

    Each decode step starts from the reference's cache carried across, so
    1e-4 holds one step. Chained through the port's own caches the
    recurrentgemma logits drift to 1.3e-4 scaled at the third step (float32
    summation order, carried in the states, then sharpened by the random
    weights' near one-hot local attention: max |k| ~ 37); the chained run
    is held to the same tokens and the teacher-forcing bound."""
    ref_cfg, cfg = _model_cfgs(arch)
    if arch == "recurrentgemma-2b":
        assert cfg.n_groups == 2 and cfg.tail_blocks == ("rec", "rec")
    ref, params = _model_params(ref_cfg, 50)
    tokens = np.random.default_rng(51).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got, _ = forward(params, cfg, tokens=torch.from_numpy(tokens))
    want, _ = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens))
    _close(got, want, LOGIT_TOL)

    cache = init_cache(cfg, 2, 32, "cpu")
    ref_cache = ref_model.init_cache(ref_cfg, 2, 32)
    got, cache, _ = prefill(params, cfg, cache, tokens=torch.from_numpy(tokens))
    want, ref_cache, _ = ref_model.prefill(ref, ref_cfg, ref_cache, tokens=jnp.asarray(tokens))
    _close(got, want, LOGIT_TOL)
    _trees_close(cache, ref_cache, LOGIT_TOL)
    pos = np.full((2, 1), 12, np.int32)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)
        carried = _carry(ref_cache)
        before = jax.tree.map(torch.clone, carried)
        got, new_cache = decode_step(params, cfg, carried, torch.from_numpy(nxt),
                                     torch.from_numpy(pos))
        chained, cache = decode_step(params, cfg, cache, torch.from_numpy(nxt),
                                     torch.from_numpy(pos))
        want, ref_cache = ref_model.decode_step(ref, ref_cfg, ref_cache, jnp.asarray(nxt),
                                                jnp.asarray(pos))
        jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("cache modified"),
                     carried, before)
        _close(got, want, LOGIT_TOL)
        _trees_close(new_cache, ref_cache, LOGIT_TOL)
        _close(chained, want, TEACHER_TOL)
        for out in (got, chained):
            assert np.array_equal(out.argmax(-1).numpy(), np.asarray(jnp.argmax(want, -1)))
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_forward_by_teacher_forcing(arch):
    """The reference's ``test_decode_consistency_with_forward`` on the port
    (reduced config, its own depth), and the port's forward against the
    reference's."""
    ref_cfg, cfg = _cfgs(arch)
    ref, params = _model_params(ref_cfg, 1)
    T = 12
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (1, T + 1)).astype(np.int32))
    full, _ = forward(params, cfg, tokens=tokens)
    pre, cache, _ = prefill(params, cfg, init_cache(cfg, 1, 64, "cpu"), tokens=tokens[:, :T])
    step, _ = decode_step(params, cfg, cache, tokens[:, T:], torch.full((1, 1), T,
                                                                        dtype=torch.int32))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, T].numpy(),
                               rtol=TEACHER_TOL, atol=TEACHER_TOL)
    np.testing.assert_allclose(pre[:, -1].numpy(), full[:, T - 1].numpy(),
                               rtol=TEACHER_TOL, atol=TEACHER_TOL)
    want, _ = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens.numpy()))
    _close(full, want, LOGIT_TOL)


@pytest.mark.parametrize("kind", ["rec", "local", "mlstm", "slstm"])
def test_blocks_in_bfloat16_compute_stay_close(kind):
    """Each block kind in bfloat16 compute on the same bf16 input, 10 steps
    (the window is 8). Per block, not per model: through 8 random-weight
    layers a one-ulp bf16 difference in a near one-hot local-attention
    score moves which token is attended (scores in the hundreds, an ulp of
    0.5), so whole-model bf16 logits of the two frameworks part beyond the
    first position; the blocks stay within 1e-2 of each other."""
    arch = "xlstm-1.3b" if kind in ("mlstm", "slstm") else "recurrentgemma-2b"
    ref_cfg, cfg = _model_cfgs(arch, compute_dtype="bfloat16")
    ref, params = _init(ref_model.block_specs(ref_cfg, kind), 52)
    x = jnp.asarray(_x((2, 10, cfg.d_model), 53, scale=1.0)).astype(jnp.bfloat16)
    positions = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    got, _, _ = model.apply_block(kind, params, _carry(x), cfg,
                                  positions=torch.from_numpy(positions.copy()), cache=None)
    want, _, _ = ref_model.apply_block(kind, ref, x, ref_cfg, positions=jnp.asarray(positions),
                                       cache=None)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16_TOL)


# ----------------------------------------------------------- sparse serving
def _registrations(engine):
    return {n: (l.fingerprint, l.density, l.d_in, l.d_out, l.spmv_eligible, l.weight_t.tobytes())
            for n, l in engine._by_name.items()}


def test_recurrentgemma_pruned_ffns_and_engine_logits_match_the_reference():
    """Every ``rec`` and ``local`` block's GeGLU FFN is pruned and registered
    under the reference's names (3 per block: 24 at 8 layers); the engine's
    logits equal the dense path's and the reference's on the same pruned
    weights, over a forward and a decode step."""
    ref_cfg, cfg = _model_cfgs("recurrentgemma-2b")
    ref, params = _model_params(ref_cfg, 54)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_pruned = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    regs = _registrations(port_engine)
    assert regs == _registrations(ref_engine)
    blocks = [f"g{p}x{g}" for p in range(3) for g in range(2)] + ["tail0", "tail1"]
    assert sorted(regs) == sorted(f"{b}.mlp.{w}" for b in blocks
                                  for w in ("w_gate", "w_up", "w_down"))
    assert sl.ffn_block_names(cfg) == ref_sl.ffn_block_names(ref_cfg)
    assert regs["g0x0.mlp.w_up"][2:4] == (cfg.d_model, cfg.d_ff)  # d_in, d_out
    assert torch.equal(pruned["groups"][0]["rec"]["wa"], params["groups"][0]["rec"]["wa"])

    tokens = np.random.default_rng(55).integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    handle = port_engine.bind("latency")
    sparse, _ = forward(pruned, cfg, tokens=torch.from_numpy(tokens), unroll_layers=True,
                        engine=handle)
    dense, _ = forward(pruned, cfg, tokens=torch.from_numpy(tokens))
    want, _ = ref_model.forward(ref_pruned, ref_cfg, tokens=jnp.asarray(tokens))
    _close(sparse, dense.numpy(), LOGIT_TOL)
    _close(sparse, want, LOGIT_TOL)
    assert port_engine.stats.plans == len(regs) == 24
    assert port_engine.stats.dense_fallbacks == 0

    logits, cache, _ = prefill(pruned, cfg, init_cache(cfg, 1, 32, "cpu"),
                               tokens=torch.from_numpy(tokens))
    _, ref_cache, _ = ref_model.prefill(ref_pruned, ref_cfg, ref_model.init_cache(ref_cfg, 1, 32),
                                        tokens=jnp.asarray(tokens))
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((1, 1), 5, dtype=torch.int32)
    before = port_engine.stats.spmv_matmuls
    step, _ = decode_step(pruned, cfg, cache, nxt, pos, unroll_layers=True, engine=handle)
    step_dense, _ = decode_step(pruned, cfg, cache, nxt, pos)
    ref_step, _ = ref_model.decode_step(ref_pruned, ref_cfg, ref_cache,
                                        jnp.asarray(nxt.numpy()), jnp.asarray(pos.numpy()))
    assert port_engine.stats.spmv_matmuls - before == 24
    _close(step, step_dense.numpy(), LOGIT_TOL)
    _close(step, ref_step, LOGIT_TOL)


def test_xlstm_registers_no_matrix_in_either_package():
    ref_cfg, cfg = _cfgs("xlstm-1.3b")
    ref, params = _model_params(ref_cfg, 56)
    port_engine, ref_engine = engines()
    pruned = sl.prune_model_ffns(params, cfg, port_engine, density=0.1)
    ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    assert port_engine.stats.registered == ref_engine.stats.registered == 0
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("an xLSTM leaf was pruned"),
                 pruned, params)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_decodes_the_reference_models_greedy_tokens(arch):
    """Three requests over two slots, so the third lands in slot 1 while
    slot 0 decodes: the slot surgery must carry every recurrent leaf (h,
    conv, C, n, c, m) and the ring into axis 1 of the group-stacked cache
    (with 2 groups, writing axis 0 would overwrite a group). recurrentgemma
    is served sparse, xLSTM dense (no FFN for the engine)."""
    ref_cfg, cfg = _model_cfgs(arch)
    if arch == "xlstm-1.3b":
        ref_cfg, cfg = (c.replace(n_layers=4) for c in (ref_cfg, cfg))  # 2 groups
    assert cfg.n_groups == 2
    ref, params = _model_params(ref_cfg, 57)
    engine = None
    if arch == "recurrentgemma-2b":
        engine, ref_engine = engines()
        params = sl.prune_model_ffns(params, cfg, engine, density=0.1)
        ref = ref_sl.prune_model_ffns(ref, ref_cfg, ref_engine, density=0.1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).tolist()
               for _ in range(3)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    server = BatchedServer(params, cfg, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=5),
                           engine=engine)
    done = server.run(reqs)
    assert [r.generated for r in done] == [
        _ref_greedy(ref, ref_cfg, p, 5, 32) for p in prompts]
    if engine is not None:
        assert engine.stats.spmv_matmuls == 24 * server.ticks


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cli_serves_the_recurrent_archs_on_the_cpu(arch, tmp_path):
    out = tmp_path / "summary.json"
    argv = ["--arch", arch, "--device", "cpu", "--requests", "2", "--slots", "2",
            "--max-new-tokens", "3", "--max-len", "64", "--summary-export", str(out)]
    if arch == "recurrentgemma-2b":
        argv.append("--lm-sparse")
    done = launch_serve.main(argv)
    assert [len(r.generated) for r in done] == [3, 3]
    import json

    engine = json.loads(out.read_text()).get("engine")
    if arch == "recurrentgemma-2b":  # reduced: one (rec, rec, local) group
        assert engine["registered"] == engine["spmv_layers"] == 9
        assert engine["objectives"]["latency"] == {"plans": 9, "formats": "csr"}
    else:
        assert engine is None


def test_block_specs_of_the_recurrent_kinds_build_every_arch_leaf():
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        specs = model_specs(cfg)
        assert all(block_specs(cfg, k) for k in cfg.pattern)
        ref_specs = ref_model.model_specs(ref_configs.get_config(arch))
        assert _spec_tuples(specs) == _spec_tuples(ref_specs)
