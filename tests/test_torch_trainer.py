"""The port's training path (``repro_torch.train.trainer`` over
``models.model.forward`` with ``cfg.remat``) against the reference's
``jax.value_and_grad`` on the CPU, and the reference's trainer tests
mirrored on the port.

Configs: every arch's reduced config cut to a tiny width (d 64, 2 heads,
d_ff 128, vocabulary 128; ``attn_chunk`` 16 so that T = 32 runs the chunked
flash loop with fully masked chunks; recurrentgemma's window 8; MoE
experts of 32), float32. Parameters are the reference's ``jax.random``
draw carried across with ``params_from_numpy``; batches are the
reference's ``batch_at``. Tolerances: the loss 1e-5 relative, every
gradient leaf 1e-4 after scaling by max |reference leaf|.

At the reference's random init (``std = 1 / sqrt(shape[-2])``, so
``wq: (d, h, dh)`` draws with ``fan_in`` = 2 heads) attention without
qk-norm is near one-hot, and a relative 1e-6 nudge of the parameters
moves some archs' whole-model gradients by more than 1e-4 in either
package (``AMPLIFYING``). There the whole-model bound is ill-posed: each
block's VJP is held to 1e-4 under the same upstream cotangent
(``test_block_vjp_matches_jax``), and the whole model's gradients to the
move that nudge makes (``_nudge_move``), which is asserted to exceed 1e-4.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMDataset as RefDataset
from repro.models import model as ref_model
from repro.models import layers as ref_layers
from repro.models import param as ref_param
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import Trainer as RefTrainer
from repro.train import TrainConfig as RefTrainConfig
from repro.train import trainer as ref_trainer
from repro.optim.compress import init_error_feedback as ref_init_error_feedback
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import forward, model, params_from_numpy
from repro_torch.models import layers
from repro_torch.models.moe import select_dispatch_format
from repro_torch.models.param import params_to_numpy, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, Trainer, make_loss_fn, make_train_step
from repro_torch.train.trainer import init_train_state

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NUDGE = 1e-6
ARCHS = tuple(ref_configs.ARCH_IDS)
# measured at these configs: the port's whole-model gradients against the
# reference's (a relative 1e-6 nudge of the params moves the port's own):
# deepseek 6.0e-4 (1.2e-3), kimi 1.2e-4 (1.5e-3), codeqwen 1.2e-4 (2.3e-3),
# stablelm 1.2e-4 (1.4e-3), musicgen 1.5e-4 (1.4e-3), paligemma 5.1e-4
# (3.6e-3). The reference's own gradients move by up to 7.9e-5 (kimi) from
# eager to jitted; every other arch holds GRAD_TOL whole (qwen3 1.3e-6).
AMPLIFYING = {"deepseek-moe-16b", "kimi-k2-1t-a32b", "codeqwen1.5-7b", "stablelm-12b",
              "musicgen-large", "paligemma-3b"}
T, B = 32, 2


def _tiny(mod, arch, **kw):
    c = mod.get_config(arch, reduced_config=True)
    base = dict(d_model=64, n_heads=2, n_kv_heads=min(c.n_kv_heads, 2), head_dim=32, d_ff=128,
                vocab_size=128, attn_chunk=16)
    if c.n_experts:
        base["d_ff_expert"] = 32
    if c.window:
        base["window"] = 8
    return c.replace(**{**base, **kw})


def _cfgs(arch, **kw):
    return _tiny(ref_configs, arch, **kw), _tiny(configs, arch, **kw)


def _skew(tree):
    """Scale two router columns of every MoE layer up: routing crowds those
    experts and the ``ell`` / ``sell`` capacities overflow."""
    def one(path, a):
        return a.at[..., :2].multiply(6.0) if "router" in jax.tree_util.keystr(path) else a
    return jax.tree_util.tree_map_with_path(one, tree)


def _ref_params(ref_cfg, seed=0, skew=False):
    p = ref_param.init_params(ref_model.model_specs(ref_cfg), jax.random.PRNGKey(seed),
                              ref_cfg.param_dtype)
    return _skew(p) if skew else p


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _batch(ref_cfg, seed=0, mask=None):
    dc = RefDataConfig(
        vocab_size=ref_cfg.vocab_size, seq_len=T, global_batch=B, seed=seed,
        embed_dim=ref_cfg.d_model if ref_cfg.train_input == "embeds" or ref_cfg.prefix_len else 0,
        prefix_len=ref_cfg.prefix_len)
    b = RefDataset(dc).batch_at(0)
    if mask is not None:
        b["loss_mask"] = mask
    return b


def _to_ref(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_port(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _port_value_and_grad(cfg, params, batch):
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
    loss, aux = make_loss_fn(cfg)(tree_unflatten(params, leaves), _to_port(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_map(torch.Tensor.detach, aux), tree_unflatten(params, list(grads))


def _leaf_errors(port_tree, ref_tree) -> dict:
    """{key: max |port - ref| / max |ref|} over the reference's leaves."""
    ref_flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref_tree))[0]
    port_leaves = jax.tree.leaves(params_to_numpy(port_tree))
    assert len(ref_flat) == len(port_leaves) > 0
    out = {}
    for (path, r), p in zip(ref_flat, port_leaves):
        assert p.shape == r.shape
        r, p = r.astype(np.float64), p.astype(np.float64)
        out[jax.tree_util.keystr(path)] = float(np.max(np.abs(p - r))
                                                / max(np.max(np.abs(r)), 1e-30))
    return out


def _nudge_move(cfg, params, batch, grads) -> float:
    """How far a relative ``NUDGE`` of every parameter moves the port's own
    gradients (max over leaves, scaled by each leaf's max |.|)."""
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda p: p * (1 + NUDGE * torch.randn(p.shape, generator=gen)), params)
    _, _, moved = _port_value_and_grad(cfg, nudged, batch)
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(tree_leaves(moved), tree_leaves(grads)))


def _check_model(arch, *, mask=None, skew=False, **kw):
    """Loss, aux and every gradient leaf of one batch against
    ``jax.value_and_grad`` of the reference's ``make_loss_fn``."""
    ref_cfg, cfg = _cfgs(arch, **kw)
    ref_p = _ref_params(ref_cfg, skew=skew)
    params = _carry(ref_p)
    batch = _batch(ref_cfg, mask=mask)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        ref_trainer.make_loss_fn(ref_cfg), has_aux=True))(ref_p, _to_ref(batch))
    loss, aux, grads = _port_value_and_grad(cfg, params, batch)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert float(aux["moe_aux"]) == pytest.approx(float(ref_aux["moe_aux"]), rel=LOSS_TOL,
                                                  abs=1e-7)
    np.testing.assert_array_equal(aux["tokens_per_expert"].numpy(),
                                  np.asarray(ref_aux["tokens_per_expert"]))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    errs = _leaf_errors(grads, ref_grads)
    worst = max(errs.values())
    if worst > GRAD_TOL:
        assert arch in AMPLIFYING, {k: v for k, v in errs.items() if v > GRAD_TOL}
        move = _nudge_move(cfg, params, batch, grads)
        assert GRAD_TOL < move and worst <= move, (arch, worst, move)
    return float(loss)


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch):
    _check_model(arch)


@pytest.mark.parametrize("dispatch", ["dense", "ell", "sell"])
def test_moe_gradients_under_each_dispatch_with_capacity_drops(dispatch):
    loss = _check_model("deepseek-moe-16b", skew=True, dispatch_format=dispatch)
    if dispatch != "dense":  # the skewed router overflowed a capacity: tokens dropped
        ref_cfg, cfg = _cfgs("deepseek-moe-16b", dispatch_format="dense")
        with torch.no_grad():
            dense, _ = make_loss_fn(cfg)(_carry(_ref_params(ref_cfg, skew=True)),
                                         _to_port(_batch(ref_cfg)))
        assert abs(loss - float(dense)) > 1e-4


MASKS = {
    "half": lambda: np.random.default_rng(4).random((B, T)) < 0.5,
    "none-kept": lambda: np.zeros((B, T), bool),
}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-large", "paligemma-3b"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_loss_mask_embeds_and_prefix_match(arch, mask):
    """``loss_mask``; musicgen trains on ``embeds``, paligemma on tokens
    behind a prefix of ``prefix_embeds`` (its logits cut to the last T)."""
    _check_model(arch, mask=MASKS[mask]())


# ---------------------------------------------------------------- per block
BLOCKS = {
    "attn": ("codeqwen1.5-7b", "attn", {}),
    "attn-gelu": ("musicgen-large", "attn", {}),
    "attn-prefix-lm": ("paligemma-3b", "attn", {}),
    "attn-qk-norm": ("qwen3-0.6b", "attn", {}),
    "local": ("recurrentgemma-2b", "local", {}),
    # capacity factor 0.5 (8 slots of 32 tokens) with the skewed router: drops
    "moe-dense": ("deepseek-moe-16b", "moe", {"dispatch_format": "dense",
                                              "capacity_factor": 0.5}),
    "moe-ell": ("deepseek-moe-16b", "moe", {"dispatch_format": "ell", "capacity_factor": 0.5}),
    "moe-sell": ("deepseek-moe-16b", "moe", {"dispatch_format": "sell",
                                             "capacity_factor": 0.5}),
    "rec": ("recurrentgemma-2b", "rec", {}),
    "mlstm": ("xlstm-1.3b", "mlstm", {}),
    "slstm": ("xlstm-1.3b", "slstm", {}),
}


def _block_vjp(name):
    arch, kind, kw = BLOCKS[name]
    ref_cfg, cfg = _cfgs(arch, **kw)
    ref_p = ref_param.init_params(ref_model.block_specs(ref_cfg, kind), jax.random.PRNGKey(3),
                                  ref_cfg.param_dtype)
    ref_p = _skew(ref_p)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, ref_cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(B, T, ref_cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()

    def ref_fn(p, x):
        y, _, (aux, _) = ref_model.apply_block(kind, p, x, ref_cfg, positions=jnp.asarray(pos),
                                               cache=None)
        return y, aux

    def ref_vjp(p, x, dy):
        (y, _), vjp = jax.vjp(ref_fn, p, x)
        return y, vjp((dy, jnp.ones((), jnp.float32)))

    ref_y, (ref_gp, ref_gx) = jax.jit(ref_vjp)(ref_p, jnp.asarray(x), jnp.asarray(dy))
    params = _carry(ref_p)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    xt = torch.from_numpy(x).requires_grad_()
    y, _, aux = model.apply_block(kind, tree_unflatten(params, leaves), xt, cfg,
                                  positions=torch.from_numpy(pos), cache=None)
    obj = (y * torch.from_numpy(dy)).sum() + (aux[0] if aux is not None else 0.0)
    grads = torch.autograd.grad(obj, leaves + [xt], allow_unused=True, materialize_grads=True)
    errs = _leaf_errors(tree_unflatten(params, list(grads[:-1])), ref_gp)
    errs["x"] = float(np.max(np.abs(grads[-1].numpy() - np.asarray(ref_gx)))
                      / np.max(np.abs(np.asarray(ref_gx))))
    y_err = float(np.max(np.abs(y.detach().numpy() - np.asarray(ref_y)))
                  / np.max(np.abs(np.asarray(ref_y))))
    return y.detach(), y_err, errs


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_vjp_matches_jax(name):
    """Every block kind's VJP (parameters and input) under the same upstream
    cotangent, the MoE aux's included; MoE routing skewed."""
    y, y_err, errs = _block_vjp(name)
    assert y_err <= LOSS_TOL
    assert max(errs.values()) <= GRAD_TOL, {k: v for k, v in errs.items() if v > GRAD_TOL}
    if name in ("moe-ell", "moe-sell"):  # tokens were dropped at the capacity
        assert float((_block_vjp("moe-dense")[0] - y).abs().max()) > 1e-3


@pytest.mark.parametrize("window,prefix_len", [(8, 0), (0, 8), (6, 4)])
def test_fully_masked_chunks_keep_finite_gradients(window, prefix_len):
    """The chunked flash loop over chunks where a query sees nothing
    (``NEG_INF`` is finite, so no NaN enters the ``where``), and padded
    keys: its VJP against the reference's."""
    rng = np.random.default_rng(2)
    S, H, dh, chunk = 40, 2, 8, 16
    q, k, v, dy = (rng.normal(size=(1, S, H, dh)).astype(np.float32) * 3 for _ in range(4))
    pos = np.arange(S, dtype=np.int32)[None]
    valid = np.ones((1, S), bool)
    kw = dict(window=window, prefix_len=prefix_len, chunk=chunk)
    ok = (pos[0][None, :] <= pos[0][:, None])
    if window:
        ok &= pos[0][None, :] > pos[0][:, None] - window
    if prefix_len:
        ok |= pos[0][None, :] < prefix_len
    assert any(not ok[i, c:c + chunk].any() for i in range(S) for c in range(0, S, chunk))

    def ref_fn(q, k, v):
        return ref_layers.flash_attention(q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                                          kv_valid=jnp.asarray(valid), **kw)

    def ref_vjp(q, k, v, dy):
        out, vjp = jax.vjp(ref_fn, q, k, v)
        return out, vjp(dy)

    ref_out, ref_grads = jax.jit(ref_vjp)(*(jnp.asarray(a) for a in (q, k, v, dy)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = layers.flash_attention(*ts, q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                                 kv_valid=torch.from_numpy(valid), **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5, rtol=1e-5)
    for g, r in zip(grads, ref_grads):
        assert bool(torch.isfinite(g).all())
        r = np.asarray(r)
        assert float(np.max(np.abs(g.numpy() - r)) / np.max(np.abs(r))) <= GRAD_TOL


# -------------------------------------------------------------------- remat
REMAT_ARCHS = {"qwen3-0.6b": {}, "deepseek-moe-16b": {"dispatch_format": "sell"},
               "recurrentgemma-2b": {}, "xlstm-1.3b": {}}


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_remat_on_equals_off_and_recomputes_only_group_blocks(arch, monkeypatch):
    ref_cfg, cfg = _cfgs(arch, **REMAT_ARCHS[arch])
    params = _carry(_ref_params(ref_cfg, skew=True))
    batch = _batch(ref_cfg)
    calls = []
    real = model.apply_block
    monkeypatch.setattr(model, "apply_block",
                        lambda kind, *a, **k: (calls.append(kind), real(kind, *a, **k))[1])
    n_group_blocks = cfg.n_groups * len(cfg.pattern)
    n_blocks = n_group_blocks + len(cfg.first_blocks) + len(cfg.tail_blocks)
    out = {}
    for remat in (True, False):
        calls.clear()
        loss, aux, grads = _port_value_and_grad(cfg.replace(remat=remat), params, batch)
        # remat: each group block runs again on the backward pass
        assert len(calls) == n_blocks + (n_group_blocks if remat else 0)
        out[remat] = (loss, aux, grads)
    (l1, a1, g1), (l0, a0, g0) = out[True], out[False]
    assert float(l1) == float(l0)
    assert float(a1["moe_aux"]) == float(a0["moe_aux"])  # added once, not per recompute
    assert torch.equal(a1["tokens_per_expert"], a0["tokens_per_expert"])
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max().clamp(min=1e-30))
    calls.clear()
    with torch.no_grad():
        forward(params, cfg, tokens=_to_port(batch)["tokens"])
    assert len(calls) == n_blocks  # no gradient taken: nothing recomputed


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("compress_frac", [0.0, 0.25])
def test_train_step_matches_the_reference(compress_frac):
    ref_cfg, cfg = _cfgs("qwen3-0.6b")
    ref_oc = RefAdamWConfig(learning_rate=3e-3, weight_decay=0.1)
    oc = AdamWConfig(learning_rate=3e-3, weight_decay=0.1)
    ref_p = _ref_params(ref_cfg)
    ref_s = ref_init_opt_state(ref_p, ref_oc)
    if compress_frac:
        ref_s["error"] = ref_init_error_feedback(ref_p)
    params, state = _carry(ref_p), _carry(ref_s)
    ref_step = jax.jit(ref_trainer.make_train_step(ref_cfg, ref_oc, compress_frac=compress_frac))
    step = make_train_step(cfg, oc, compress_frac=compress_frac)
    for i in range(2):
        batch = _batch(ref_cfg, seed=i)
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, _to_ref(batch))
        params, state, m = step(params, state, _to_port(batch))
        assert sorted(m) == sorted(ref_m)
        for key in m:
            assert float(m[key]) == pytest.approx(float(ref_m[key]), rel=GRAD_TOL, abs=1e-7), key
        assert int(state["step"]) == int(ref_s["step"]) == i + 1
        assert max(_leaf_errors(params, ref_p).values()) <= GRAD_TOL
        for key in ("m", "v") + (("error",) if compress_frac else ()):
            assert max(_leaf_errors(state[key], ref_s[key]).values()) <= GRAD_TOL, key
        for leaf in tree_leaves(params):
            assert leaf.grad_fn is None and not leaf.requires_grad


# ------------------------------------------------- the reference's trainer tests
def _tiny_setup(tmp_path, steps=6, compress=0.0):
    cfg = configs.get_config("qwen3-0.6b", reduced_config=True).replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=128, attn_chunk=32,
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    oc = AdamWConfig(learning_rate=3e-3, weight_decay=0.0, state_dtype="float32")
    tc = TrainConfig(steps=steps, log_every=100, ckpt_every=3,
                     ckpt_dir=str(tmp_path / "ckpt"), compress_frac=compress)
    return cfg, dc, oc, tc


def test_trainer_loss_decreases_and_resumes(tmp_path):
    cfg, dc, oc, tc = _tiny_setup(tmp_path, steps=6)
    trainer = Trainer(cfg, dc, oc, tc, device="cpu")
    params, opt = init_train_state(cfg, oc, seed=0, device="cpu")
    trainer.run(params, opt)
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert trainer.ckpt.all_steps() == [3, 6]
    tc2 = TrainConfig(**{**tc.__dict__, "steps": 8})
    trainer2 = Trainer(cfg, dc, oc, tc2, device="cpu")
    p2, o2 = init_train_state(cfg, oc, seed=0, device="cpu")
    trainer2.run(p2, o2)
    assert [h["step"] for h in trainer2.history] == [6, 7]


def test_trainer_matches_the_reference_trainer(tmp_path):
    """Both trainers from the same parameters over the same batches: the
    same losses step by step, and the same checkpoint (resumable by both)."""
    cfg, dc, oc, tc = _tiny_setup(tmp_path / "port", steps=4)
    ref_cfg = ref_configs.get_config("qwen3-0.6b", reduced_config=True).replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=128, attn_chunk=32)
    ref_oc = RefAdamWConfig(learning_rate=3e-3, weight_decay=0.0, state_dtype="float32")
    ref_tc = RefTrainConfig(steps=4, log_every=100, ckpt_every=3,
                            ckpt_dir=str(tmp_path / "ref" / "ckpt"))
    ref_p = _ref_params(ref_cfg)
    ref_trainer_ = RefTrainer(ref_cfg, RefDataConfig(**dc.__dict__), ref_oc, ref_tc)
    ref_trainer_.run(ref_p, ref_init_opt_state(ref_p, ref_oc))
    trainer = Trainer(cfg, dc, oc, tc, device="cpu")
    params = _carry(ref_p)
    trainer.run(params, init_opt_state(params, oc))
    assert [h["step"] for h in trainer.history] == [h["step"] for h in ref_trainer_.history]
    for got, want in zip(trainer.history, ref_trainer_.history):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
    # the port's checkpoint resumes the reference's trainer and back
    ref_tc6 = RefTrainConfig(**{**ref_tc.__dict__, "steps": 6, "ckpt_dir": tc.ckpt_dir})
    ref_resumed = RefTrainer(ref_cfg, RefDataConfig(**dc.__dict__), ref_oc, ref_tc6)
    ref_resumed.run(ref_p, ref_init_opt_state(ref_p, ref_oc))
    assert [h["step"] for h in ref_resumed.history] == [4, 5]


def test_trainer_with_compression(tmp_path):
    cfg, dc, oc, tc = _tiny_setup(tmp_path, steps=3, compress=0.25)
    trainer = Trainer(cfg, dc, oc, tc, device="cpu")
    params, opt = init_train_state(cfg, oc, seed=0, compress_frac=0.25, device="cpu")
    assert sorted(opt) == ["error", "m", "step", "v"]
    trainer.run(params, opt)
    assert len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)


def test_preemption_checkpoint(tmp_path):
    cfg, dc, oc, tc = _tiny_setup(tmp_path, steps=50)
    trainer = Trainer(cfg, dc, oc, tc, device="cpu")
    params, opt = init_train_state(cfg, oc, seed=0, device="cpu")
    orig_step = trainer.step_fn

    def step_and_preempt(p, o, b):
        trainer._preempted = True  # simulate SIGTERM mid-run
        return orig_step(p, o, b)

    trainer.step_fn = step_and_preempt
    trainer.run(params, opt)
    assert len(trainer.history) == 1  # stopped immediately after the hook
    assert trainer.ckpt.latest_step() == 1  # but saved first


def test_moe_training_with_selected_dispatch(tmp_path):
    """The run-time mode driving the MoE dispatch format inside a (tiny)
    training loop: loss must decrease under the selected format."""
    cfg = configs.get_config("deepseek-moe-16b", reduced_config=True).replace(
        d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
        d_ff_expert=32, vocab_size=256, attn_chunk=32,
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=1)
    oc = AdamWConfig(learning_rate=3e-3, weight_decay=0.0)
    params, _ = init_train_state(cfg, oc, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(dc).batch_at(0).items()}
    with torch.no_grad():
        _, aux = make_loss_fn(cfg)(params, batch)
    fmt = select_dispatch_format(aux["tokens_per_expert"])
    assert fmt in ("ell", "sell")
    cfg = cfg.replace(dispatch_format=fmt)
    tc = TrainConfig(steps=5, log_every=100, ckpt_every=100, ckpt_dir=str(tmp_path))
    trainer = Trainer(cfg, dc, oc, tc, device="cpu")
    params, opt = init_train_state(cfg, oc, seed=0, device="cpu")
    trainer.run(params, opt)
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 5 and losses[-1] < losses[0]


def test_init_train_state_draws_on_the_device_from_a_seeded_generator():
    cfg = _tiny_setup(pathlib.Path("."))[0]
    oc = AdamWConfig(state_dtype="bfloat16")
    p1, o1 = init_train_state(cfg, oc, seed=3, device="cpu")
    p2, _ = init_train_state(cfg, oc, seed=3, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    p3, _ = init_train_state(cfg, oc, seed=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert not torch.equal(p1["embed"], p3["embed"])
    assert o1["m"]["embed"].dtype == torch.bfloat16 and o1["step"].dtype == torch.int32
    assert p1["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, oc)  # device=None means the card
