"""The port's multi-device path against its one-device path, with numbers
that really move: four gloo ranks on the CPU (a ``FileStore`` under the
test's temporary directory) form a (2, 2) ``("data", "model")`` mesh, and
each rank runs

* one ``make_train_step`` step of ``qwen3-0.6b`` and of the reduced
  ``deepseek-moe-16b`` (``ell`` dispatch) at a tiny width, parameters,
  moments and batch as DTensors placed by the ``train`` rules, under
  ``sharding_context`` and ``implicit_replication``;
* the same loss's gradients alone (``make_loss_fn`` under autograd);
* a prefill of 8 tokens and one decode step into a cache placed by the
  ``infer`` rules.

Every rank also runs the same calls on plain tensors (the one-device path,
which ``tests/test_torch_trainer.py`` holds against ``jax.value_and_grad``)
and reports ``max |sharded - plain| / max |plain|`` per quantity, the
maximum over leaves. Every quantity is held to 1e-5. A gradient that a
replicated copy should have summed over the mesh but did not, or summed
twice, is off by a factor of 2.

Two choices make that bound well posed. AdamW's first step is
``lr * sign(g)`` wherever ``|g|`` is far above ``eps``, so a gradient of
float32 noise flips its update; ``eps`` is 1e-3 here, which keeps the
update Lipschitz in the gradient. And at the reference's init attention is
near one-hot (``wq`` draws with ``fan_in`` = heads): a float32 reordering
there moves deepseek's gradients by 4.2e-5 (measured), as
``test_torch_trainer.AMPLIFYING`` records for the one-device path. ``wq``
is scaled by 0.1 in both runs, which softens the attention and leaves the
gradients' sharding as it was.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

TOL = 1e-5
ARCHS = ("qwen3-0.6b", "deepseek-moe-16b")
QUANTITIES = ("loss", "step_loss", "grads", "params", "m", "v", "prefill_logits",
              "decode_logits", "cache")
WORKER = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.dist import RULE_SETS, batch_sharding, build_sharding, sharding_context
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec, place
    from repro_torch.models import decode_step, init_params, model_specs, prefill
    from repro_torch.models.model import cache_specs, init_cache
    from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_loss_fn, make_train_step

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    B, T, PROMPT, MAX_LEN = 4, 32, 8, 16

    def tiny(arch, **kw):
        c = configs.get_config(arch, reduced_config=True)
        base = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
                    vocab_size=128, attn_chunk=16)
        if c.n_experts:
            base["d_ff_expert"] = 32
        return c.replace(**{**base, **kw})

    def err(got, want):
        got = got.full_tensor() if isinstance(got, DTensor) else got
        got, want = got.detach().double(), want.detach().double()
        return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))

    def worst(got, want):
        return max(err(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))

    def value_and_grad(loss_fn, params, batch):
        leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), batch)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    report = {}
    for arch, kw in (("qwen3-0.6b", {}), ("deepseek-moe-16b", {"dispatch_format": "ell"})):
        cfg = tiny(arch, **kw)
        gen = torch.Generator().manual_seed(0)
        params = init_params(model_specs(cfg), gen, "float32", "cpu")
        for block in params["head"] + params["groups"] + params["tail"]:
            if "attn" in block:
                block["attn"]["wq"] = block["attn"]["wq"] * 0.1
        batch = {k: torch.randint(0, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        oc = AdamWConfig(learning_rate=1e-3, eps=1e-3, weight_decay=0.1)
        loss_fn, step = make_loss_fn(cfg), make_train_step(cfg, oc)
        state = init_opt_state(params, oc)
        loss, grads = value_and_grad(loss_fn, params, batch)
        new_p, new_s, metrics = step(params, state, batch)
        cache = init_cache(cfg, B, MAX_LEN, "cpu")
        prompt, nxt = batch["tokens"][:, :PROMPT], batch["tokens"][:, PROMPT:PROMPT + 1]
        pos = torch.full((B, 1), PROMPT, dtype=torch.int32)
        pf_logits, cache, _ = prefill(params, cfg, cache, tokens=prompt)
        dc_logits, cache = decode_step(params, cfg, cache, nxt, pos)

        sh = build_sharding(mesh, model_specs(cfg))
        with sharding_context(mesh), implicit_replication():
            d_params = tree_map(place, params, sh)
            d_batch = tree_map(place, batch, batch_sharding(mesh, batch))
            d_state = {"m": tree_map(place, state["m"], sh), "v": tree_map(place, state["v"], sh),
                       "step": place(state["step"], NamedSharding(mesh, PartitionSpec()))}
            d_loss, d_grads = value_and_grad(loss_fn, d_params, d_batch)
            d_new_p, d_new_s, d_metrics = step(d_params, d_state, d_batch)
        sharded = [tuple(p.is_shard() for p in t.placements) for t in tree_leaves(d_params)]
        rules = RULE_SETS["infer"]
        sh = build_sharding(mesh, model_specs(cfg), rules)
        rows = lambda t: place(t, batch_sharding(mesh, {"t": t}, rules)["t"])
        with sharding_context(mesh, rules), implicit_replication():
            d_params = tree_map(place, params, sh)
            d_cache = tree_map(place, init_cache(cfg, B, MAX_LEN, "cpu"),
                               build_sharding(mesh, cache_specs(cfg, B, MAX_LEN), rules))
            d_pf_logits, d_cache, _ = prefill(d_params, cfg, d_cache, tokens=rows(prompt))
            d_dc_logits, d_cache = decode_step(d_params, cfg, d_cache, rows(nxt), rows(pos))
        report[arch] = {
            "loss": err(d_loss, loss), "step_loss": err(d_metrics["loss"], metrics["loss"]),
            "grads": worst(d_grads, grads), "params": worst(d_new_p, new_p),
            "m": worst(d_new_s["m"], new_s["m"]), "v": worst(d_new_s["v"], new_s["v"]),
            "prefill_logits": err(d_pf_logits, pf_logits),
            "decode_logits": err(d_dc_logits, dc_logits), "cache": worst(d_cache, cache),
            "sharded_on": sorted({i for pl in sharded for i, p in enumerate(pl) if p}),
        }
    with open(out, "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The four ranks' reports (rank -> arch -> quantity -> error)."""
    tmp = tmp_path_factory.mktemp("mesh_step")
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp),
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1] / "src")}
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(tmp / "store"),
                               str(tmp / f"rank{r}.json")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {r: json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)}


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_the_one_device_step(report, arch, quantity):
    for rank, by_arch in report.items():
        assert by_arch[arch][quantity] <= TOL, (rank, arch, quantity, by_arch[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_shards_parameters_over_both_axes(report, arch):
    """The comparison is not of replicated copies: under the ``train``
    rules some parameter is sharded over ``data`` and some over ``model``."""
    assert all(by_arch[arch]["sharded_on"] == [0, 1] for by_arch in report.values())
