"""The port's examples (``examples/torch_*.py``) on the CPU, each held
against the reference's own flow (``examples/{quickstart, autotune_formats,
serve_lm, train_lm}.py``) run through the reference's library calls on the
same matrices and arguments.

On the CPU the port's tuner learns as the reference's does (the
reference-equal cost model, here with the reference's constants handed
over as the other parity tests do, and ``OverheadPredictor``), and both
packages' §5.3 samples read one scripted clock (``same_clocks``), so the
plans, formats and conversion decisions must be equal; the modelled gains
and overheads to 1e-9 relative. The LM examples get the reference's parameters
carried across (``params_from_numpy``): the sparse-served decode logits are
held to 1e-4 of the largest logit, the training losses to 1e-5 relative.
Without ``--device`` every example raises on a machine without a card."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import AutoSpMV as RefAutoSpMV
from repro.core import AutoSpmvPredictor as RefPredictor
from repro.core import AutoSpmvSession as RefSession
from repro.core import OverheadPredictor as RefOverhead
from repro.core import PredictorConfig as RefPredictorConfig
from repro.core import collect_dataset as ref_collect
from repro.core import extract_features as ref_features
from repro.core import measure_overheads as ref_measure
from repro.core import should_convert as ref_should_convert
from repro.core import overhead as ref_overhead_mod
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMDataset as RefDataset
from repro.models import init_params as ref_init_params
from repro.models import model as ref_model
from repro.models import model_specs as ref_specs
from repro.models.moe import select_dispatch_format as ref_select
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import cosine_schedule as ref_cosine
from repro.sparse.generate import MATRIX_NAMES, generate_by_name as ref_generate
from repro.sparse.registry import default_format as ref_default_format
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro.train.trainer import init_train_state as ref_init_train_state
from repro.train.trainer import make_loss_fn as ref_loss_fn
from repro_torch.core import overhead as port_overhead_mod
from repro_torch.core.objectives import CostModel
from repro_torch.models import params_from_numpy
from repro_torch.optim import init_opt_state
from torch_port_helpers import assert_scaled_close, reference_profile, same_clocks, schedule_dict

ROOT = Path(__file__).resolve().parents[1]
SCALE = 0.001
RTOL = 1e-9  # modelled gains and overheads: the same arithmetic in float64
LOGITS_TOL = 1e-4  # scaled by the largest logit; the reduced configs compute in float32
LOSS_TOL = 1e-5
EXAMPLES = ("torch_quickstart", "torch_autotune_formats", "torch_serve_lm", "torch_train_lm")


def _load(name: str):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _reference_labels(monkeypatch, example):
    """The example's tuner labels with the reference's constants and reads
    the same scripted clock for its §5.3 samples as the reference's."""
    same_clocks(monkeypatch, ref_overhead_mod, port_overhead_mod)
    monkeypatch.setattr(example, "default_cost_model",
                        lambda device: CostModel(reference_profile()))
    return example


def _ref_tuner(names, overhead_names):
    """The reference examples' tuner: dataset, decision tree, §5.3 ridge."""
    ds = ref_collect(scale=SCALE, names=names, n_extra=8)
    pred = RefPredictor(RefPredictorConfig()).fit(ds)
    oh = RefOverhead().fit([ref_measure(ref_generate(m, scale=SCALE), m)
                            for m in overhead_names])
    return RefAutoSpMV(pred, oh)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_without_a_device_raise_where_there_is_no_card(name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])


def test_quickstart_decides_as_the_reference(monkeypatch, capsys):
    ex = _reference_labels(monkeypatch, _load("torch_quickstart"))
    out = ex.main(["--device", "cpu", "--scale", str(SCALE)])
    text = capsys.readouterr().out
    assert "43008 records" in text and "kernel correct" in text and text.endswith("done.\n")

    tuner = _ref_tuner(MATRIX_NAMES[:16], MATRIX_NAMES[:8])
    feats = ref_features(ref_generate("consph", scale=SCALE))
    ct = tuner.plan_compile_time(feats, "latency")
    rt = tuner.plan_run_time(feats, "latency")
    assert schedule_dict(out["schedule"]) == schedule_dict(ct.schedule)
    assert out["best_format"] == rt.best_format
    assert out["convert"] == ref_should_convert(rt, 5000, ref_default_format())
    assert out["gain_per_iter"] == pytest.approx(rt.gain_per_iter, rel=RTOL)
    assert out["overhead_s"] == pytest.approx(rt.overhead_s, rel=RTOL)
    assert out["kernel_err"] <= (3e-2 if out["schedule"].accum_dtype == "bfloat16" else 1e-4)


def test_autotune_formats_table_is_the_references(monkeypatch, capsys, tmp_path):
    ex = _reference_labels(monkeypatch, _load("torch_autotune_formats"))
    cache = tmp_path / "cache.json"
    out = ex.main(
        ["--device", "cpu", "--scale", str(SCALE), "--cache", str(cache)])
    text = capsys.readouterr().out
    assert "tuning cache saved" in text and "kernels correct: 12 products" in text

    names = MATRIX_NAMES[:12]
    session = RefSession(_ref_tuner(names, names[:8]))
    mats = [ref_generate(m, scale=SCALE) for m in names]
    want = session.optimize_many(mats, "efficiency", mode="run", n_iterations=2000)
    assert [r["matrix"] for r in out["rows"]] == list(names)
    for got, rt in zip(out["rows"], want):
        assert (got["format"], got["convert"]) == (rt.best_format, rt.convert), got
        assert got["gain_per_iter"] == pytest.approx(rt.predicted_gain_per_iter, rel=RTOL)
        assert got["overhead_s"] == pytest.approx(rt.predicted_overhead, rel=RTOL)
    ref_stats = session.stats
    assert (out["session"]["feature_extractions"], out["session"]["plans_computed"],
            out["session"]["requests"]) == (ref_stats.feature_extractions,
                                            ref_stats.plans_computed, ref_stats.requests)
    for check in out["checks"]:
        assert check["err"] <= (3e-2 if check["schedule"].accum_dtype == "bfloat16" else 1e-4)


def test_serve_lm_sparse_check_holds_against_the_reference(monkeypatch, capsys):
    ref_ex = _load("serve_lm")  # the reference's example, for its build_sparse_engine
    cfg = ref_configs.get_config("qwen3-0.6b", reduced_config=True)
    params = ref_init_params(ref_specs(cfg), jax.random.PRNGKey(0), cfg.param_dtype)
    port_ex = _load("torch_serve_lm")
    monkeypatch.setattr(port_ex, "init_params", lambda *a, **k: params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    out = port_ex.main(["--device", "cpu", "--sparse", "--requests", "2", "--slots", "1",
                        "--max-new-tokens", "2"])
    text = capsys.readouterr().out
    assert "req 0" in text and "req 1" in text and "4 tokens in" in text
    assert "dense-vs-sparse decode logits" in text and "energy cells" in text
    assert out["summary"]["engine"]["registered"] == 6

    # the reference's check_numerics, step by step, on its own engine
    engine, pruned = ref_ex.build_sparse_engine(cfg, params, 0.05)
    B, T = 1, 6
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)), jnp.int32)
    cache = ref_model.init_cache(cfg, B, 64)
    logits, cache, _ = ref_model.prefill(pruned, cfg, cache, tokens=tokens)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    pos = jnp.full((B, 1), T, jnp.int32)
    ld, _ = ref_model.decode_step(pruned, cfg, cache, nxt, pos)
    engine.plan_all("latency")
    ls, _ = ref_model.decode_step(pruned, cfg, cache, nxt, pos, unroll_layers=True,
                                  engine=engine.bind("latency"))
    ld, ls = np.asarray(ld, np.float32), np.asarray(ls, np.float32)
    assert_scaled_close(out["numerics"]["dense"], ld, LOGITS_TOL)
    assert_scaled_close(out["numerics"]["sparse"], ls, LOGITS_TOL)
    assert out["numerics"]["max_abs_diff"] < 5e-4


def test_train_lm_first_losses_are_the_references(monkeypatch, capsys, tmp_path):
    p = _load("torch_train_lm").PRESETS["tiny"]
    cfg = ref_configs.get_config("deepseek-moe-16b", reduced_config=True)
    cfg = cfg.replace(d_model=p["d_model"], n_heads=max(2, p["d_model"] // 32),
                      n_kv_heads=max(1, min(cfg.n_kv_heads, p["d_model"] // 32)), head_dim=32,
                      d_ff=2 * p["d_model"] if cfg.d_ff else 0,
                      d_ff_expert=p["d_model"] // 2 if cfg.d_ff_expert else 0,
                      attn_chunk=64, vocab_size=min(cfg.vocab_size, 2048))
    steps = 2
    opt_cfg = RefAdamWConfig(learning_rate=ref_cosine(2e-3, 20, steps),
                             state_dtype=cfg.opt_state_dtype)
    data_cfg = RefDataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                             global_batch=p["batch"], seed=0, prefix_len=cfg.prefix_len,
                             embed_dim=cfg.d_model if cfg.train_input == "embeds" else 0)
    params, _ = ref_init_train_state(cfg, opt_cfg, seed=0)
    batch = {k: jnp.asarray(v) for k, v in RefDataset(data_cfg).batch_at(0).items()}
    _, aux = jax.jit(lambda q, b: ref_loss_fn(cfg)(q, b))(params, batch)
    fmt = ref_select(aux["tokens_per_expert"])
    cfg = cfg.replace(dispatch_format=fmt)
    ref = RefTrainer(cfg, data_cfg, opt_cfg, RefTrainConfig(
        steps=steps, log_every=20, ckpt_every=50, ckpt_dir=str(tmp_path / "ref")))
    ref.run(*ref_init_train_state(cfg, opt_cfg, seed=0))

    ex = _load("torch_train_lm")

    def carried(cfg_, opt_cfg_, seed=0, compress_frac=0.0, *, device=None):
        q = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        return q, init_opt_state(q, opt_cfg_)

    monkeypatch.setattr(ex, "init_train_state", carried)
    trainer = ex.main(["--device", "cpu", "--preset", "tiny", "--steps", str(steps),
                       "--ckpt-dir", str(tmp_path / "port")])
    text = capsys.readouterr().out
    assert f"routing histogram -> {fmt!r}" in text and "loss:" in text
    assert trainer.cfg.dispatch_format == fmt
    got = [h["loss"] for h in trainer.history]
    want = [h["loss"] for h in ref.history]
    assert len(got) == len(want) == steps
    assert got == pytest.approx(want, rel=LOSS_TOL)
    assert trainer.ckpt.latest_step() == steps
