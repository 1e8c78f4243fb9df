"""The port's recurrent blocks (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) and their wiring in ``models.model``, against the reference
on the CPU (whole models and serving: tests/test_torch_recurrent_lm.py).

Configs: ``recurrentgemma-2b`` and ``xlstm-1.3b`` reduced (d 128, 4 heads;
RG-LRU width 64, conv 4; mLSTM chunk 16; float32), recurrentgemma with its
depth raised to 8 layers (two groups of (rec, rec, local) and a (rec, rec)
tail) and its window cut to 8 wherever a served or decoded sequence should
wrap the local-attention ring. Parameters are the reference's
``jax.random`` draw carried across with ``params_from_numpy``; inputs are
seeded numpy arrays. Tolerances after scaling by max |reference|: 1e-5 for
a mixer or a block, 1e-4 for logits, 5e-3 for teacher forcing (the
reference's own test), 3e-2 in bfloat16. Sequence lengths at chunk 16:
1, below a chunk, one chunk, and not a multiple of the chunk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro.models import param as ref_param
from repro.models import recurrent as ref_rec
from repro_torch import configs
from repro_torch.models import cache_specs, init_cache, params_from_numpy
from repro_torch.models import model
from repro_torch.models import recurrent as rec
from repro_torch.models.param import init_params

from torch_port_helpers import assert_scaled_close

BLOCK_TOL, LOGIT_TOL, TEACHER_TOL, BF16_TOL = 1e-5, 1e-4, 5e-3, 3e-2
TS = (1, 5, 16, 21)  # at mlstm_chunk 16: one step, below, equal, not a multiple
ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")
RG_LAYERS = 8  # 2 groups of (rec, rec, local) + the (rec, rec) tail


def _cfgs(arch, **kw):
    """(reference config, port config) of the reduced ``arch``."""
    return (ref_configs.get_config(arch, reduced_config=True).replace(**kw),
            configs.get_config(arch, reduced_config=True).replace(**kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(tree):
    return params_from_numpy(_np(tree), "cpu")


def _init(ref_specs, seed, dtype="float32"):
    """The reference's draw of ``ref_specs`` and the port's copy."""
    ref = ref_param.init_params(ref_specs, jax.random.PRNGKey(seed), dtype)
    return ref, _carry(ref)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(port, ref, tol=BLOCK_TOL):
    assert_scaled_close(port.detach().numpy() if isinstance(port, torch.Tensor) else port,
                        np.asarray(ref), tol)


def _trees_close(port_tree, ref_tree, tol=BLOCK_TOL):
    port_leaves = jax.tree.leaves(jax.tree.map(
        lambda t: t.float().numpy(), port_tree, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    ref_leaves = jax.tree.leaves(_np(ref_tree))
    assert len(port_leaves) == len(ref_leaves) > 0
    for p, r in zip(port_leaves, ref_leaves):
        _close(p, np.asarray(r, np.float32), tol)


def _spec_tuples(tree):
    return jax.tree.map(dataclasses.astuple, tree,
                        is_leaf=lambda s: dataclasses.is_dataclass(s))


# -------------------------------------------------------------------- specs
SPECS = {"rglru": "recurrentgemma-2b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("mixer", sorted(SPECS))
def test_mixer_and_cache_specs_equal_the_reference(mixer, reduced):
    cfg = configs.get_config(SPECS[mixer], reduced_config=reduced)
    ref_cfg = ref_configs.get_config(SPECS[mixer], reduced_config=reduced)
    specs, ref_specs = getattr(rec, f"{mixer}_specs"), getattr(ref_rec, f"{mixer}_specs")
    assert _spec_tuples(specs(cfg)) == _spec_tuples(ref_specs(ref_cfg))
    cache, ref_cache = (getattr(m, f"{mixer}_cache_spec") for m in (rec, ref_rec))
    for c, r in ((cfg, ref_cfg), (cfg.replace(state_dtype="bfloat16"),
                                  ref_cfg.replace(state_dtype="bfloat16"))):
        assert _spec_tuples(cache(c, 3)) == _spec_tuples(ref_cache(r, 3))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_the_references_with_the_slstm_normaliser_at_ones(arch):
    ref_cfg, cfg = _cfgs(arch, n_layers=RG_LAYERS) if arch.startswith("rec") else _cfgs(arch)
    got, want = init_cache(cfg, 2, 24, "cpu"), ref_model.init_cache(ref_cfg, 2, 24)
    assert _spec_tuples(cache_specs(cfg, 2, 24)) == _spec_tuples(
        ref_model.cache_specs(ref_cfg, 2, 24))
    got_leaves = jax.tree.leaves(jax.tree.map(
        lambda t: t, got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    for g, w in zip(got_leaves, jax.tree.leaves(want)):
        assert g.dtype == getattr(torch, str(w.dtype)) and np.array_equal(g.numpy(), w)
    if arch == "xlstm-1.3b":
        n = got["groups"][1]["n"]
        assert n.shape == (cfg.n_groups, 2, cfg.n_heads, cfg.d_model // cfg.n_heads)
        assert bool((n == 1).all()) and bool((got["groups"][1]["c"] == 0).all())


# ------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", TS)
def test_causal_conv1d_matches_the_reference(T, with_state):
    x, w, b = _x((2, T, 24), 1), _x((4, 24), 2), _x((24,), 3)
    state = _x((2, 3, 24), 4) if with_state else None
    y, new = rec._causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)),
                                None if state is None else torch.from_numpy(state))
    ref_y, ref_new = ref_rec._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            None if state is None else jnp.asarray(state))
    _close(y, ref_y)
    np.testing.assert_array_equal(new.numpy(), np.asarray(ref_new))


def test_lru_gates_match_the_reference_with_softplus_beyond_its_linear_switch():
    """``F.softplus`` switches to the identity above 20; JAX's softplus does
    not. Over lam in [-4, 30] the gates agree to float32 rounding: beyond
    20, log1p(exp(-lam)) < 2.1e-9 is under half an ulp of lam. (Far below
    -4, a = 1 - O(ulp) and sqrt(1 - a^2) cancels in both packages alike,
    an ulp of exp apart: no test of softplus.)"""
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    ref, params = _init(ref_rec.rglru_specs(ref_cfg), 5)
    lam = np.linspace(-4.0, 30.0, cfg.rnn_dim).astype(np.float32)
    ref["lam"] = jnp.asarray(lam)
    params["lam"] = torch.from_numpy(lam)
    xc = _x((2, 7, cfg.rnn_dim), 6)
    a, b = rec._lru_gates(params, torch.from_numpy(xc), cfg)
    ref_a, ref_b = ref_rec._lru_gates(ref, jnp.asarray(xc), ref_cfg)
    _close(a, ref_a)
    _close(b, ref_b)
    big = torch.tensor([20.5, 25.0, 30.0])
    np.testing.assert_array_equal(torch.nn.functional.softplus(big).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(big.numpy()))))


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33, 256])
def test_linear_scan_equals_the_associative_scan_and_a_float64_loop(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.95, 0.999, (2, T, 8)).astype(np.float32)  # ~0.98 a step
    b = rng.normal(size=(2, T, 8)).astype(np.float32)
    got = rec.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _, want = jax.lax.associative_scan(
        lambda u, v: (u[0] * v[0], u[1] * v[0] + v[1]), (jnp.asarray(a), jnp.asarray(b)),
        axis=1)
    h, seq = np.zeros((2, 8)), np.zeros((2, T, 8))
    for t in range(T):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq[:, t] = h
    _close(got, want)
    _close(got, seq)


def test_linear_scan_survives_where_a_cumprod_underflows():
    """4,096 steps at a ~ 0.98: prod(a) reaches 1e-36 (float32's normal
    range ends at 1.2e-38); dividing by it, as a cumprod-based scan would,
    loses h. The doubling scan never divides."""
    T = 4096
    a = np.full((1, T, 4), 0.98, np.float32)
    b = _x((1, T, 4), 7)
    got = rec.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    h, last = np.zeros((1, 4)), None
    for t in range(T):
        h = 0.98 * h + b[:, t].astype(np.float64)
    last = h
    assert np.isfinite(got).all()
    _close(got[:, -1], last)


@pytest.mark.parametrize("T", TS)
def test_rglru_matches_the_reference_without_state(T):
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    ref, params = _init(ref_rec.rglru_specs(ref_cfg), 8)
    x = _x((2, T, cfg.d_model), 9)
    y, cache = rec.rglru(params, torch.from_numpy(x), cfg)
    ref_y, _ = ref_rec.rglru(ref, jnp.asarray(x), ref_cfg)
    assert cache is None
    _close(y, ref_y)


def _rec_cache(cfg, seed, B=2):
    return {"h": _x((B, cfg.rnn_dim), seed), "conv": _x((B, cfg.conv1d_size - 1, cfg.rnn_dim),
                                                        seed + 1)}


def test_rglru_decode_step_matches_the_reference_and_reads_the_first_step_only():
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    ref, params = _init(ref_rec.rglru_specs(ref_cfg), 10)
    cache = _rec_cache(cfg, 11)
    x = _x((2, 1, cfg.d_model), 12)
    y, new = rec.rglru(params, torch.from_numpy(x), cfg, cache=_carry(cache))
    ref_y, ref_new = ref_rec.rglru(ref, jnp.asarray(x), ref_cfg,
                                   cache=jax.tree.map(jnp.asarray, cache))
    _close(y, ref_y)
    _trees_close(new, ref_new)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", TS)
def test_rglru_with_state_matches_the_reference(T, with_state):
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    ref, params = _init(ref_rec.rglru_specs(ref_cfg), 13)
    cache = _rec_cache(cfg, 14) if with_state else None
    x = _x((2, T, cfg.d_model), 15)
    y, new = model._rglru_with_state(params, torch.from_numpy(x), cfg,
                                     cache=None if cache is None else _carry(cache))
    ref_y, ref_new = ref_model._rglru_with_state(
        ref, jnp.asarray(x), ref_cfg,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    _close(y, ref_y)
    if with_state:
        _trees_close(new, ref_new)
    else:
        assert new is None and ref_new is None


@pytest.mark.parametrize("split", [1, 5, 16])
def test_rglru_prefill_with_state_then_decode_equals_one_pass(split):
    """Prefill of a prefix, prefill of the rest over its state, then decode
    steps: the same outputs as one stateless pass over the whole."""
    _, cfg = _cfgs("recurrentgemma-2b")
    _, params = _init(ref_rec.rglru_specs(_cfgs("recurrentgemma-2b")[0]), 16)
    T = 24
    x = torch.from_numpy(_x((2, T, cfg.d_model), 17))
    whole, _ = rec.rglru(params, x, cfg)
    zero = init_params(rec.rglru_cache_spec(cfg, 2), None, "float32", "cpu")
    y1, c = model._rglru_with_state(params, x[:, :split], cfg, cache=zero)
    y2, c = model._rglru_with_state(params, x[:, split:T - 3], cfg, cache=c)
    steps = []
    for t in range(T - 3, T):
        y, c = model._rglru_with_state(params, x[:, t:t + 1], cfg, cache=c)
        steps.append(y)
    _close(torch.cat([y1, y2, *steps], dim=1), whole.numpy())


# -------------------------------------------------------------------- mLSTM
def _mlstm_inputs(T, seed, B=2, H=4, dh=8):
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(B, T, H, dh)).astype(np.float32) for _ in range(3)]
    i_g = rng.uniform(0.2, 1.0, (B, T, H)).astype(np.float32)
    f_g = rng.uniform(0.8, 0.999, (B, T, H)).astype(np.float32)
    state = (rng.normal(size=(B, H, dh, dh)).astype(np.float32),
             rng.normal(size=(B, H, dh)).astype(np.float32))
    return (*qkv, i_g, f_g), state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", TS + (40,))
def test_mlstm_core_matches_the_reference(T, with_state):
    ins, state = _mlstm_inputs(T, 20 + T)
    state = state if with_state else None
    out, (C, n) = rec._mlstm_core(*(torch.from_numpy(a) for a in ins), 16,
                                  None if state is None else tuple(map(torch.from_numpy, state)))
    ref_out, (ref_C, ref_n) = ref_rec._mlstm_core(
        *(jnp.asarray(a) for a in ins), 16,
        None if state is None else tuple(map(jnp.asarray, state)))
    _close(out, ref_out)
    _close(C, ref_C)
    _close(n, ref_n)


def test_mlstm_chunked_prefill_then_decode_equals_the_sequential_recurrence():
    """The reference test's sequential mLSTM in float64: a chunked pass over
    21 steps from a carried state, then decode steps, equal it step by step
    (the prefill and decode paths of ``_mlstm_core`` held to each other)."""
    T = 24
    ins, state = _mlstm_inputs(T, 30)
    q, k, v, i_g, f_g = (a.astype(np.float64) for a in ins)
    C, n = (s.astype(np.float64) for s in state)
    want = np.zeros_like(q)
    for t in range(T):
        ki = k[:, t] * i_g[:, t, :, None]
        C = f_g[:, t, :, None, None] * C + np.einsum("bhk,bhv->bhkv", ki, v[:, t])
        n = f_g[:, t, :, None] * n + ki
        qt = q[:, t] * q.shape[-1] ** -0.5
        den = np.maximum(np.abs(np.einsum("bhk,bhk->bh", qt, n))[..., None], 1.0)
        want[:, t] = np.einsum("bhk,bhkv->bhv", qt, C) / den
    t_ins = [torch.from_numpy(a) for a in ins]
    st = tuple(map(torch.from_numpy, state))
    outs = []
    out, st = rec._mlstm_core(*(a[:, :21] for a in t_ins), 16, st)
    outs.append(out)
    for t in range(21, T):
        out, st = rec._mlstm_core(*(a[:, t:t + 1] for a in t_ins), 16, st)
        outs.append(out)
    _close(torch.cat(outs, dim=1), want)
    _close(st[0], C)


def _block_cache(kind, cfg, seed, B=2):
    spec = {"mlstm": rec.mlstm_cache_spec, "slstm": rec.slstm_cache_spec}[kind](cfg, B)
    rng = np.random.default_rng(seed)
    out = {}
    for key, s in spec.items():
        a = rng.normal(size=s.shape).astype(np.float32) * 0.5
        out[key] = np.abs(a) + 0.5 if key == "n" else a  # a normaliser stays positive
    return out


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_the_reference(kind, T, with_state):
    ref_cfg, cfg = _cfgs("xlstm-1.3b")
    ref, params = _init(getattr(ref_rec, f"{kind}_specs")(ref_cfg), 40)
    x = _x((2, T, cfg.d_model), 41)
    cache = _block_cache(kind, cfg, 42) if with_state else None
    fn, ref_fn = getattr(rec, f"{kind}_block"), getattr(ref_rec, f"{kind}_block")
    y, new = fn(params, torch.from_numpy(x), cfg, cache=None if cache is None else _carry(cache))
    ref_y, ref_new = ref_fn(ref, jnp.asarray(x), ref_cfg,
                            cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    _close(y, ref_y)
    if with_state:
        assert set(new) == set(ref_new)
        _trees_close(new, ref_new)
        assert all(new[k].dtype == torch.float32 for k in new)
    else:
        assert new is None


def test_mlstm_block_keeps_a_bfloat16_state_in_its_dtype():
    ref_cfg, cfg = _cfgs("xlstm-1.3b", state_dtype="bfloat16")
    ref, params = _init(ref_rec.mlstm_specs(ref_cfg), 43)
    x = _x((1, 5, cfg.d_model), 44)
    cache = init_params(rec.mlstm_cache_spec(cfg, 1), None, "float32", "cpu")
    ref_cache = ref_param.init_params(ref_rec.mlstm_cache_spec(ref_cfg, 1),
                                      jax.random.PRNGKey(0), "float32")
    y, new = rec.mlstm_block(params, torch.from_numpy(x), cfg, cache=cache)
    ref_y, ref_new = ref_rec.mlstm_block(ref, jnp.asarray(x), ref_cfg, cache=ref_cache)
    assert new["C"].dtype == torch.bfloat16 and ref_new["C"].dtype == jnp.bfloat16
    _close(y, ref_y)
    _trees_close(new, ref_new, BF16_TOL)
