"""A pruned dense FFN served by the port's sparse inference engine.

Set-up draws the FFN's three weights from the seed on the device (Gaussian),
prunes each on the host with the frozen magnitude rule to the configuration's
density, registers them with ``SparseInferenceEngine(session)`` at its
defaults, plans them all for the objective and runs a first step. A step is
one decode step of the FFN, the port's own ``models/layers.mlp`` with the
engine: ``down(silu(gate(x)) * up(x))`` on one pooled activation of
``tokens`` sequences of one token, each matmul through ``engine.matmul``.

The control (``control=True``) builds the engine with ``force_fp32=False``
and serves each plan's schedule with bfloat16 accumulation."""

from __future__ import annotations

import numpy as np
import torch

from bench.harness.seeds import subseed
from bench.harness.yardstick import spmv_call_work
from bench.reference.generate import gaussian
from bench.reference.prune import magnitude_prune
from bench.reference.products import gated_ffn

# the port's name of a gated FFN of the configuration's activation
MLP_KIND = {"silu": "swiglu"}


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, *,
                 control: bool = False, tuner=None):
        if cfg["precision"] != "float32":
            raise ValueError(f"precision {cfg['precision']!r}: the benchmark serves float32")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.tuner = tuner
        self.tokens = int(mix["tokens"])
        d, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
        # (engine name, (d_in, d_out)), in the order of the port's mlp
        self.mats = [(f"{cfg['block']}.mlp.{w}", s)
                     for w, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))]
        self.hidden = d
        self.products_per_step = len(self.mats) * self.tokens

    def inputs(self) -> None:
        gen = torch.Generator(self.device).manual_seed(subseed(self.seed, "weights"))
        raw = gaussian([s for _, s in self.mats], float(self.cfg["init_std"]), gen, self.device)
        self.weights = [magnitude_prune(w.cpu().numpy(), float(self.cfg["density"])) for w in raw]
        del raw
        gen = torch.Generator(self.device).manual_seed(subseed(self.seed, "pool"))
        # a decode step: `tokens` sequences of one token each
        pool = torch.randn(int(self.mix["pool"]), self.tokens, 1, self.hidden, generator=gen,
                           device=self.device)
        self.pool_host = pool.cpu().numpy()
        self.pool = list(pool.unbind(0)) if self.mix["x_on"] == "device" else list(self.pool_host)
        # bytes and operations a step needs: each matrix once for all tokens
        works = [spmv_call_work(s[1], s[0], int(np.count_nonzero(w)), self.tokens)
                 for (_, s), w in zip(self.mats, self.weights)]
        self.work = tuple(sum(x) for x in zip(*works))

    def build_tuner(self):
        from repro_torch.core.session import build_tuner

        if self.tuner is None:
            self.tuner = build_tuner(device=self.device, **self.cfg["tuner"])
        return self.tuner

    def first_answer(self):
        """Register the pruned weights, plan them all, then a first step."""
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.session import AutoSpmvSession
        from repro_torch.kernels.ops import compile_spmv
        from repro_torch.models.layers import mlp
        from repro_torch.models.sparse_linear import EngineHandle, SparseInferenceEngine

        engine = SparseInferenceEngine(AutoSpmvSession(self.tuner), force_fp32=not self.control)
        for (name, _), w in zip(self.mats, self.weights):
            engine.register(name, w)
        objective = self.cfg["objective"]
        if engine.plan_all(objective) != len(self.mats):
            raise RuntimeError("the engine routes a pruned matrix to its dense fallback")
        if self.control:
            for name, _ in self.mats:
                layer = engine.layer(name)
                plan, _ = engine.plan(name, objective)
                engine._plans[(layer.fingerprint, objective)] = (plan, compile_spmv(
                    layer.weight_t, plan.fmt, plan.schedule.replace(accum_dtype="bfloat16"),
                    device=self.tuner.device, memo_key=layer.fingerprint))
        cfg, pub = self.cfg, self.cfg["published"]
        self.model = ModelConfig(
            name=cfg["block"], family="moe", n_layers=int(cfg["num_hidden_layers"]),
            d_model=self.hidden, n_heads=int(pub["num_attention_heads"]),
            n_kv_heads=int(pub["num_key_value_heads"]), d_ff=int(cfg["intermediate_size"]),
            vocab_size=int(pub["vocab_size"]), mlp_kind=MLP_KIND[cfg["hidden_act"]],
            param_dtype=cfg["precision"], compute_dtype=cfg["precision"])
        self.engine, self.objective = engine, objective
        self.handle, self.mlp = EngineHandle(engine, objective), mlp
        # the model's own leaves, which the dense fallback would read
        self.params = {name.rsplit(".", 1)[1]: torch.from_numpy(w).to(self.device)
                       for (name, _), w in zip(self.mats, self.weights)}
        return self.step(self.pool[0])

    def step(self, x):
        return (self.mlp(self.params, x, self.model, engine=self.handle, name=self.cfg["block"]),)

    def describe(self) -> dict:
        plans = [self.engine.plan(name, self.objective) for name, _ in self.mats]
        return {"formats": [p.fmt for p, _ in plans],
                "schedules": [p.schedule.as_dict() for p, _ in plans],
                "served_accum": [k.schedule.accum_dtype for _, k in plans],
                "nnz": [int(np.count_nonzero(w)) for w in self.weights],
                "engine": self.engine.stats.as_dict()}

    def release(self) -> None:
        from repro_torch.kernels.ops import clear_kernel_memo

        self.engine = self.handle = self.params = self.pool = None
        clear_kernel_memo()

    def reference(self, pool_index: int) -> tuple[np.ndarray]:
        if not hasattr(self, "_ref"):  # every pooled activation at once
            x = self.pool_host.reshape(-1, self.hidden)
            self._ref = gated_ffn(x, *self.weights).reshape(self.pool_host.shape)
        return (self._ref[pool_index],)
