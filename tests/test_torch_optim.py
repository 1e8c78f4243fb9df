"""The port's optimizer (``repro_torch.optim``: AdamW, the schedules and
top-k gradient compression) against the reference on the CPU.

Inputs are numpy arrays from a seed, handed to both packages; parameter
trees are nested like a model's (dicts and tuples, bf16 leaves among
them). Tolerance 1e-6 after scaling by max |reference| (float32; the
global norm sums its leaves in another order); the sets compression keeps
must be equal. The reference's own optimizer tests are mirrored on the
port beside the parity cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.models import params_from_numpy
from repro_torch.models.param import params_to_numpy, tree_leaves
from repro_torch.optim import (
    AdamWConfig,
    apply_adamw,
    compress_gradients,
    constant,
    cosine_schedule,
    init_error_feedback,
    init_opt_state,
    linear_warmup,
)
from repro_torch.optim import adamw, compress

TOL = 1e-6


def _scaled_err(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref), initial=0.0) / max(np.max(np.abs(ref), initial=0.0), 1e-30))


def _trees_close(port_tree, ref_tree, tol=TOL, dtypes=True):
    """Leaf for leaf by key (both trees sorted the JAX way), scaled."""
    port_leaves = jax.tree.leaves(params_to_numpy(port_tree))
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))
    assert len(port_leaves) == len(ref_leaves) > 0
    for p, r in zip(port_leaves, ref_leaves):
        if dtypes:
            assert p.dtype == r.dtype, (p.dtype, r.dtype)
        assert _scaled_err(p.astype(np.float32), r.astype(np.float32)) <= tol


def _tree(seed=0, bf16=False):
    """A model-like tree of numpy arrays: dicts, a tuple of blocks, a
    stacked leaf, optionally a bf16 leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    tree = {"embed": f(16, 8), "blocks": ({"w": f(8, 8), "ln": f(8)}, {"w": f(8, 8), "ln": f(8)}),
            "groups": ({"wq": f(3, 8, 2, 4)},), "final_norm": f(8)}
    if bf16:
        import ml_dtypes

        tree["blocks"][1]["w"] = tree["blocks"][1]["w"].astype(ml_dtypes.bfloat16)
    return tree


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _ref_lr(lr):
    """The same learning rate for the reference: a float, or the name of a
    schedule built by each package from the same arguments."""
    if isinstance(lr, tuple):
        return getattr(ref_optim, lr[0])(*lr[1:])
    return lr


def _port_lr(lr):
    if isinstance(lr, tuple):
        return {"constant": constant, "linear_warmup": linear_warmup,
                "cosine_schedule": cosine_schedule}[lr[0]](*lr[1:])
    return lr


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("sched", [("constant", 3e-4), ("linear_warmup", 1e-3, 7),
                                   ("linear_warmup", 0.5, 0), ("cosine_schedule", 1e-3, 5, 40),
                                   ("cosine_schedule", 2.0, 0, 1, 0.3),
                                   ("cosine_schedule", 1.0, 10, 110, 0.1)])
def test_schedules_match_the_reference_over_steps(sched):
    ref_f, port_f = _ref_lr(sched), _port_lr(sched)
    for step in range(0, 130):
        got = port_f(torch.tensor(step, dtype=torch.int32))
        want = ref_f(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(float(want), rel=TOL, abs=1e-12), step


def test_schedules_stay_on_the_step_counters_device():
    step = torch.tensor(3, dtype=torch.int32, device="meta")
    for f in (constant(1.0), linear_warmup(1.0, 4), cosine_schedule(1.0, 2, 8)):
        assert f(step).device.type == "meta"
    assert AdamWConfig(learning_rate=0.5).lr_at(step).device.type == "meta"


# -------------------------------------------------------------------- AdamW
ADAMW_CASES = {
    "fp32-clip": dict(learning_rate=1e-2, state_dtype="float32"),
    "fp32-noclip-nodecay": dict(learning_rate=1e-2, grad_clip_norm=0.0, weight_decay=0.0),
    "bf16-state": dict(learning_rate=1e-2, state_dtype="bfloat16"),
    "callable-lr": dict(learning_rate=("cosine_schedule", 1e-2, 2, 6), weight_decay=0.3),
    "big-clip": dict(learning_rate=3e-3, grad_clip_norm=100.0, b1=0.8, b2=0.99, eps=1e-6),
}


@pytest.mark.parametrize("bf16_param", [False, True])
@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_apply_adamw_matches_the_reference_over_steps(case, bf16_param):
    kw = dict(ADAMW_CASES[case])
    lr = kw.pop("learning_rate")
    ref_cfg = ref_adamw.AdamWConfig(learning_rate=_ref_lr(lr), **kw)
    cfg = AdamWConfig(learning_rate=_port_lr(lr), **kw)
    ref_p, p = _both(_tree(0, bf16=bf16_param))
    ref_s, s = ref_adamw.init_opt_state(ref_p, ref_cfg), init_opt_state(p, cfg)
    for step in range(5):
        grads = _tree(100 + step, bf16=bf16_param)
        ref_g, g = _both(jax.tree.map(lambda a: a * (1 + step), grads))
        ref_p, ref_s, ref_m = ref_adamw.apply_adamw(ref_p, ref_g, ref_s, ref_cfg)
        p, s, m = apply_adamw(p, g, s, cfg)
        assert s["step"].dtype == torch.int32 and int(s["step"]) == int(ref_s["step"]) == step + 1
        assert float(m["grad_norm"]) == pytest.approx(float(ref_m["grad_norm"]), rel=TOL)
        assert float(m["lr"]) == pytest.approx(float(ref_m["lr"]), rel=TOL)
        _trees_close(p, ref_p)
        _trees_close(s["m"], ref_s["m"])
        _trees_close(s["v"], ref_s["v"])
    for leaf in tree_leaves(p):
        assert not leaf.requires_grad and leaf.grad_fn is None


def test_bf16_moments_round_to_nearest_even_as_astype():
    """One step from the same state: bf16 moments are the reference's bits."""
    cfg = AdamWConfig(state_dtype="bfloat16", grad_clip_norm=0.0)
    ref_cfg = ref_adamw.AdamWConfig(state_dtype="bfloat16", grad_clip_norm=0.0)
    ref_p, p = _both(_tree(1))
    ref_g, g = _both(_tree(2))
    _, ref_s, _ = ref_adamw.apply_adamw(ref_p, ref_g, ref_adamw.init_opt_state(ref_p, ref_cfg),
                                        ref_cfg)
    _, s, _ = apply_adamw(p, g, init_opt_state(p, cfg), cfg)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(params_to_numpy(s[key])),
                        jax.tree.leaves(jax.tree.map(np.asarray, ref_s[key]))):
            assert a.dtype == b.dtype and a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_apply_adamw_walks_trees_by_key_not_by_order():
    """Grads and moments whose dicts list their keys in another order than
    the params' are matched by key."""
    cfg = AdamWConfig(learning_rate=0.1, grad_clip_norm=0.0)
    p = {"a": torch.ones(2), "b": torch.full((3,), 2.0)}
    g = {"b": torch.full((3,), 0.5), "a": torch.full((2,), -1.0)}
    s = init_opt_state({"b": p["b"], "a": p["a"]}, cfg)
    new_p, new_s, _ = apply_adamw(p, g, s, cfg)
    assert list(new_p) == ["a", "b"]
    assert torch.all(new_p["a"] > 1.0) and torch.all(new_p["b"] < 2.0)
    assert torch.equal(new_s["m"]["a"], torch.full((2,), -0.1))


def test_global_norm_matches_the_reference():
    ref_t, t = _both(_tree(4, bf16=True))
    assert float(adamw.global_norm(t)) == pytest.approx(float(ref_adamw.global_norm(ref_t)),
                                                        rel=TOL)


# the reference's optimizer tests (tests/test_substrate.py), on the port
def test_adamw_matches_reference_math():
    cfg = AdamWConfig(learning_rate=0.1, b1=0.9, b2=0.99, eps=1e-8,
                      weight_decay=0.0, grad_clip_norm=0.0)
    params = {"w": torch.tensor(2.0)}
    state = init_opt_state(params, cfg)
    new_params, state, _ = apply_adamw(params, {"w": torch.tensor(0.5)}, state, cfg)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    want = 2.0 - 0.1 * (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    assert float(new_params["w"]) == pytest.approx(want, rel=1e-5)
    assert int(state["step"]) == 1


def test_adamw_clipping_and_decay():
    cfg = AdamWConfig(learning_rate=0.1, weight_decay=0.5, grad_clip_norm=1.0)
    params = {"w": torch.ones(4)}
    new_params, _, metrics = apply_adamw(params, {"w": torch.full((4,), 100.0)},
                                         init_opt_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert bool((new_params["w"] < 1.0).all())


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor(5.0)}
    state = init_opt_state(params, cfg)
    for _ in range(200):
        params, state, _ = apply_adamw(params, {"w": 2 * params["w"]}, state, cfg)
    assert abs(float(params["w"])) < 0.2


def test_bf16_opt_state_dtype():
    state = init_opt_state({"w": torch.ones(8)}, AdamWConfig(state_dtype="bfloat16"))
    assert state["m"]["w"].dtype == torch.bfloat16 and state["step"].dtype == torch.int32


# -------------------------------------------------------------- compression
SPARSIFY_CASES = {
    "random": lambda rng: rng.normal(size=(37, 11)).astype(np.float32),
    "ties": lambda rng: np.repeat(rng.integers(-3, 4, size=40), 5).astype(np.float32),
    "all-equal": lambda rng: np.full(64, 0.25, np.float32),
    "zeros": lambda rng: np.zeros((4, 4), np.float32),
    "one": lambda rng: np.array([1.5], np.float32),
}


@pytest.mark.parametrize("frac", [-0.5, 0.0, 1e-6, 0.01, 0.1, 0.37, 0.5, 0.999, 1.0, 2.0])
@pytest.mark.parametrize("case", sorted(SPARSIFY_CASES))
def test_topk_sparsify_keeps_the_references_set(case, frac):
    g = SPARSIFY_CASES[case](np.random.default_rng(7))
    got = compress._topk_sparsify(torch.from_numpy(g), frac).numpy()
    want = np.asarray(ref_compress._topk_sparsify(jnp.asarray(g), frac))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)
    if frac <= 0:
        assert not got.any()
    elif max(int(g.size * frac), 1) >= g.size:
        np.testing.assert_array_equal(got, g)
    elif np.abs(g).max() > 0:
        assert np.count_nonzero(got) >= 1  # k >= 1


def test_topk_sparsify_keeps_every_tie_at_the_threshold():
    g = torch.tensor([3.0, -2.0, 2.0, 2.0, -2.0, 1.0, 0.5, 0.0])
    out = compress._topk_sparsify(g, 0.25)  # k = 2: threshold 2.0, four ties kept
    assert out.tolist() == [3.0, -2.0, 2.0, 2.0, -2.0, 0.0, 0.0, 0.0]


def test_kth_largest_is_the_sorted_top_ks_last_value():
    a = torch.from_numpy(np.random.default_rng(3).normal(size=1000).astype(np.float32)).abs()
    for k in (1, 2, 100, 999, 1000):
        assert float(compress._kth_largest(a, k)) == float(torch.topk(a, k).values[-1])


@pytest.mark.parametrize("frac", [0.05, 0.25, 0.0, 1.0])
def test_compress_gradients_matches_the_reference_over_steps(frac):
    ref_err, err = _both(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), _tree(0)))
    err = init_error_feedback(params_from_numpy(_tree(0), "cpu"))
    for step in range(3):
        ref_g, g = _both(_tree(10 + step, bf16=True))
        ref_c, ref_err, ref_m = ref_compress.compress_gradients(ref_g, ref_err, frac)
        c, err, m = compress_gradients(g, err, frac)
        _trees_close(c, ref_c, TOL)
        _trees_close(err, ref_err, TOL)
        for a, b in zip(jax.tree.leaves(params_to_numpy(c)),
                        jax.tree.leaves(jax.tree.map(np.asarray, ref_c))):
            np.testing.assert_array_equal(a != 0, b != 0)  # the same kept sets
        assert float(m["compress_density"]) == pytest.approx(float(ref_m["compress_density"]),
                                                             rel=TOL)
        if 0 < frac < 1:
            assert float(m["compress_density"]) >= frac * 0.9


def test_gradient_compression_error_feedback():
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 100).astype(np.float32))}
    comp, err, metrics = compress_gradients(g, init_error_feedback(g), frac=0.1)
    assert float(metrics["compress_density"]) <= 0.15
    np.testing.assert_allclose((comp["w"] + err["w"]).numpy(), g["w"].numpy(), atol=1e-6)
