"""The port's LM stack (configs, models.param/layers/model) against the
reference package on the CPU.

The same parameters go through both: the reference initialises them with
``jax.random`` and ``params_from_numpy`` carries them across leaf for leaf
(same nesting, same layouts). Inputs are numpy arrays made from a seed.
Configs: ``qwen3-0.6b`` reduced (2 layers, d 128, 4 heads, 2 KV heads,
qk-norm, ``attn_chunk`` 64, float32 compute) and the reference LM tests'
``TINY``. Tolerance 1e-5 after scaling by max |ref| (float32 throughout;
only summation order differs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import param as ref_param
from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (
    block_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    model_specs,
    param_count,
    params_from_numpy,
    prefill,
)
from repro_torch.models import layers

from torch_port_helpers import assert_scaled_close

TOL = 1e-5
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
             param_dtype="float32", compute_dtype="float32")


def _cfgs(name):
    """(reference config, port config) of one test config."""
    if name == "qwen3-reduced":
        return (ref_configs.get_config("qwen3-0.6b", reduced_config=True),
                configs.get_config("qwen3-0.6b", reduced_config=True))
    if name == "tiny":
        return RefModelConfig(**_TINY), ModelConfig(**_TINY)
    if name == "tiny-local":  # the "local" block kind and its ring cache
        kw = dict(_TINY, pattern=("local",), window=6)
        return RefModelConfig(**kw), ModelConfig(**kw)
    raise KeyError(name)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(ref_cfg, seed=0):
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(seed),
                                ref_cfg.param_dtype)
    return ref, params_from_numpy(_to_np(ref), "cpu")


def _close(port, ref, tol=TOL):
    assert_scaled_close(port.detach().numpy() if isinstance(port, torch.Tensor) else port,
                        np.asarray(ref), tol)


def _trees_close(port_tree, ref_tree, tol=TOL):
    port_leaves = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), port_tree, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    ref_leaves = jax.tree.leaves(_to_np(ref_tree))
    assert len(port_leaves) == len(ref_leaves) > 0
    for p, r in zip(port_leaves, ref_leaves):
        assert p.shape == r.shape and p.dtype == r.dtype
        if np.abs(r).max() > 0:
            assert_scaled_close(p, r, tol)
        else:
            assert not p.any()


# ------------------------------------------------------------------ configs
def test_every_config_matches_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            a = dataclasses.asdict(configs.get_config(arch, reduced_config=reduced))
            b = dataclasses.asdict(ref_configs.get_config(arch, reduced_config=reduced))
            assert a == b, arch
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_full_qwen3_config_and_param_count():
    cfg = configs.get_config("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (28, 1024, 16, 8, 128, 3072, 151_936)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    ref = ref_configs.get_config("qwen3-0.6b")
    assert param_count(model_specs(cfg)) == ref_param.param_count(ref_model.model_specs(ref))


# ------------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # bf16 in, bf16 out; the rotation itself in float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.rope(xb, torch.from_numpy(pos), 1e4).dtype == torch.bfloat16
    assert layers.rmsnorm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("S,chunk,window,prefix", [
    (24, 64, 0, 0),     # single block
    (150, 64, 0, 0),    # chunked, S padded to the chunk quantum
    (150, 64, 40, 0),   # chunked, windowed
    (128, 32, 0, 8),    # chunked, prefix-LM
])
def test_flash_attention_matches(S, chunk, window, prefix):
    rng = np.random.default_rng(S + chunk)
    B, Tq, H, dh = 2, S, 4, 16
    q = rng.normal(size=(B, Tq, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.ones((B, S), bool)
    valid[1, -5:] = False
    kw = dict(window=window, prefix_len=prefix, chunk=chunk)
    got = layers.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                                 kv_valid=torch.from_numpy(valid), **kw)
    want = ref_layers.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                                      kv_valid=jnp.asarray(valid), **kw)
    assert got.shape == (B, Tq, H, dh)
    _close(got, want)


# -------------------------------------------------------------------- params
def test_init_params_shapes_dtypes_and_fan_in_rule():
    ref_cfg, cfg = _cfgs("qwen3-reduced")
    specs = model_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), cfg.param_dtype, device="cpu")
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(0),
                                ref_cfg.param_dtype)
    ref_leaves = jax.tree_util.tree_leaves_with_path(_to_np(ref))
    got = {jax.tree_util.keystr(p): a for p, a in ref_leaves}
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(flat) == len(got)
    for path, a in flat:
        r = got[jax.tree_util.keystr(path)]
        assert a.shape == r.shape and a.dtype == r.dtype, path
    g0 = params["groups"][0]
    # std = 1 / sqrt(shape[-2]): for wq (d, h, dh) that is h, not d
    for name, fan_in in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wo", cfg.head_dim)):
        std = float(g0["attn"][name].std())
        ref_std = float(np.asarray(ref["groups"][0]["attn"][name]).std())
        assert std == pytest.approx(fan_in**-0.5, rel=0.05), name
        assert std == pytest.approx(ref_std, rel=0.05), name
    assert float(g0["mlp"]["w_up"].std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    # embed (vocab, d): shape[-2] is the vocabulary
    assert float(params["embed"].std()) == pytest.approx(cfg.vocab_size**-0.5, rel=0.05)
    assert torch.equal(g0["ln1"], torch.ones_like(g0["ln1"]))
    assert "lm_head" not in params  # tied embeddings
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(specs, torch.Generator().manual_seed(0), cfg.param_dtype)  # the card
    with pytest.raises(ValueError, match="Generator"):
        init_params(specs, None, cfg.param_dtype, device="cpu")


def test_params_from_numpy_keeps_nesting_and_bfloat16_bits():
    ref_cfg, _ = _cfgs("tiny")
    ref = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(1), "bfloat16")
    port = params_from_numpy(_to_np(ref), "cpu")
    assert isinstance(port["groups"], tuple) and isinstance(port["groups"][0], dict)
    w = port["groups"][0]["mlp"]["w_gate"]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 64, 128)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(ref["groups"][0]["mlp"]["w_gate"], np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(_to_np(ref))  # device=None is the card


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("name", ["qwen3-reduced", "tiny", "tiny-local"])
@pytest.mark.parametrize("T", [9, 100])
def test_forward_matches(name, T):
    ref_cfg, cfg = _cfgs(name)
    ref, params = _params(ref_cfg)
    tokens = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    want, _ = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens))
    got, aux = forward(params, cfg, tokens=torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, T, cfg.vocab_size)
    _close(got, want)
    assert float(aux["moe_aux"]) == 0.0


@pytest.mark.parametrize("name", ["qwen3-reduced", "tiny", "tiny-local"])
def test_prefill_and_decode_match_logits_and_caches(name):
    ref_cfg, cfg = _cfgs(name)
    ref, params = _params(ref_cfg, seed=3)
    rng = np.random.default_rng(7)
    T, max_len = 11, 32
    tokens = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    ref_cache = ref_model.init_cache(ref_cfg, 2, max_len)
    cache = init_cache(cfg, 2, max_len, "cpu")
    _trees_close(cache, ref_cache)
    want, ref_cache, _ = ref_model.prefill(ref, ref_cfg, ref_cache, tokens=jnp.asarray(tokens))
    got, cache, _ = prefill(params, cfg, cache, tokens=torch.from_numpy(tokens))
    _close(got, want)
    _trees_close(cache, ref_cache)
    pos = np.full((2, 1), T, np.int32)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)
        before = jax.tree.map(torch.clone, cache)
        want, ref_cache = ref_model.decode_step(ref, ref_cfg, ref_cache, jnp.asarray(nxt),
                                                jnp.asarray(pos))
        got, new_cache = decode_step(params, cfg, cache, torch.from_numpy(nxt),
                                     torch.from_numpy(pos))
        jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("cache modified"),
                     cache, before)
        cache = new_cache
        assert got.shape == (2, 1, cfg.vocab_size)
        _close(got, want)
        _trees_close(cache, ref_cache)
        assert np.array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(want, -1)))
        pos = pos + 1


def test_bfloat16_compute_stays_close():
    ref_cfg, cfg = _cfgs("qwen3-reduced")
    ref_cfg, cfg = (c.replace(compute_dtype="bfloat16") for c in (ref_cfg, cfg))
    ref, params = _params(ref_cfg, seed=5)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    want, _ = ref_model.forward(ref, ref_cfg, tokens=jnp.asarray(tokens))
    got, _ = forward(params, cfg, tokens=torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    _close(got, want, 3e-2)  # bf16 rounds at other places in the two frameworks


def test_engine_needs_unrolled_layers():
    _, cfg = _cfgs("tiny")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0), "float32",
                         device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unroll_layers=True"):
        forward(params, cfg, tokens=tokens, engine=object())
    cache = init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="unroll_layers=True"):
        decode_step(params, cfg, cache, tokens[:, :1], tokens[:, :1], engine=object())


@pytest.mark.parametrize("kind", ["moe", "rec", "mlstm", "slstm"])
def test_later_block_kinds_raise_not_implemented(kind):
    """Once stubs, now ported: each kind's specs equal the reference's leaf
    for leaf (tests/test_torch_moe.py and tests/test_torch_recurrent.py hold
    the rest); an unknown kind still raises."""
    ref_cfg, cfg = _cfgs("tiny")
    if kind == "moe":
        moe_kw = dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1)
        ref_cfg, cfg = ref_cfg.replace(**moe_kw), cfg.replace(**moe_kw)
    if kind == "rec":
        ref_cfg, cfg = ref_cfg.replace(rnn_width=32), cfg.replace(rnn_width=32)
    got, want = block_specs(cfg, kind), ref_model.block_specs(ref_cfg, kind)
    as_tuples = lambda t: jax.tree.map(  # noqa: E731
        dataclasses.astuple, t, is_leaf=dataclasses.is_dataclass)
    assert got.keys() == want.keys() and as_tuples(got) == as_tuples(want)
    with pytest.raises(ValueError, match="unknown block kind"):
        block_specs(cfg, "conv")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-1.3b", "recurrentgemma-2b"])
def test_configs_with_later_kinds_raise_at_their_specs(arch):
    """Once stubs, now ported: the reference's parameter shapes and count."""
    cfg = configs.get_config(arch, reduced_config=True)
    ref_cfg = ref_configs.get_config(arch, reduced_config=True)
    specs, ref_specs = model_specs(cfg), ref_model.model_specs(ref_cfg)
    assert jax.tree.map(lambda s: s.shape, specs) == jax.tree.map(
        lambda s: s.shape, ref_specs, is_leaf=lambda s: isinstance(s, ref_param.ParamSpec))
    assert param_count(specs) == ref_param.param_count(ref_specs)
    if arch == "deepseek-moe-16b":
        assert specs["groups"][0]["moe"]["w_up"].shape == (
            cfg.n_groups, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    elif arch == "xlstm-1.3b":  # (mlstm, slstm) x 1 group
        assert specs["groups"][0]["wq"].shape == (1, 2 * cfg.d_model, cfg.n_heads,
                                                   2 * cfg.d_model // cfg.n_heads)
        assert specs["groups"][1]["r_gates"].scale == 0.5
    else:  # (rec, rec, local) x 1 group
        assert specs["groups"][0]["rec"]["wa"].shape == (
            1, cfg.n_heads, cfg.rnn_dim // cfg.n_heads, cfg.rnn_dim // cfg.n_heads)
        assert specs["groups"][2]["mlp"]["w_gate"].shape == (1, cfg.d_model, cfg.d_ff)
