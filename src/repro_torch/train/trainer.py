"""Training loop with large-scale fault-tolerance posture:

* checkpoint every N steps (atomic, keep-K) + preemption hook (SIGTERM ->
  save at the next step boundary, then exit cleanly);
* stateless data pipeline resume (step-indexed PRNG, no pipeline state in
  the checkpoint);
* step-time watchdog: a step slower than ``watchdog_factor`` x the running
  median of the last 32 is logged as a straggler event;
* optional top-k gradient compression with error feedback.

``make_train_step`` builds the (params, opt, batch) -> (params, opt,
metrics) function the trainer calls: value and gradients through
``torch.autograd`` over the model's ``forward`` with no engine (the
reference's ``jax.value_and_grad``; the path launches none of the port's
CUDA kernels, as the reference's reaches no Pallas kernel), then optional
compression, then AdamW. Nothing is jitted: the step runs eagerly, and
the loss read once a step (``float(metrics["loss"])``) is its only wait for
the device. The reference's ``unroll_attn`` has no counterpart: the port's
``forward`` has no attention scan to unroll.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLMDataset
from repro_torch.dist.partition import token_nll
from repro_torch.kernels.common import resolve_device
from repro_torch.models import forward, init_params, model_specs
from repro_torch.models.param import tree_leaves, tree_unflatten
from repro_torch.optim import AdamWConfig, apply_adamw, init_opt_state
from repro_torch.optim.compress import compress_gradients, init_error_feedback
from repro_torch.utils.logging import get_logger

log = get_logger("train")


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01, unroll_layers: bool = False):
    """Masked next-token cross entropy (float32 logits) + MoE load-balance
    aux. Returns ``loss_fn(params, batch) -> (loss, aux)``."""

    def loss_fn(params, batch):
        kw = {}
        if cfg.train_input == "embeds":
            kw["embeds"] = batch["embeds"]
        else:
            kw["tokens"] = batch["tokens"]
        if cfg.prefix_len:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        logits, aux = forward(params, cfg, unroll_layers=unroll_layers, **kw)
        labels = batch["labels"]
        T = labels.shape[1]
        logits = logits[:, -T:]  # drop prefix positions (vlm)
        nll = token_nll(logits, labels)
        mask = batch.get("loss_mask")
        if mask is not None:
            nll = torch.where(mask.bool(), nll, 0.0)
            loss = nll.sum() / torch.clamp(mask.sum(), min=1)
        else:
            loss = nll.mean()
        return loss + aux_weight * aux["moe_aux"], aux

    return loss_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    compress_frac: float = 0.0,
    unroll_layers: bool = False,
) -> Callable:
    loss_fn = make_loss_fn(cfg, unroll_layers=unroll_layers)

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = tree_unflatten(params, list(grads))
        if compress_frac > 0.0:
            grads, new_err, cmetrics = compress_gradients(
                grads, opt_state["error"], compress_frac
            )
        inner = {k: opt_state[k] for k in ("m", "v", "step")}
        params, inner, metrics = apply_adamw(params, grads, inner, opt_cfg)
        new_state = dict(inner)
        if compress_frac > 0.0:
            new_state["error"] = new_err
            metrics.update(cmetrics)
        metrics["loss"] = loss.detach()
        metrics["moe_aux"] = aux["moe_aux"].detach()
        return params, new_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     compress_frac: float = 0.0, *, device=None,
                     generator: torch.Generator | None = None):
    """Parameters drawn on ``device`` (``None`` = the card) from
    ``generator`` (default: one on that device seeded with ``seed``), and
    their optimizer state (plus the error feedback when compressing)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model_specs(cfg), generator, cfg.param_dtype, device=device)
    opt_state = init_opt_state(params, opt_cfg)
    if compress_frac > 0.0:
        opt_state["error"] = init_error_feedback(params)
    return params, opt_state


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    seed: int = 0
    watchdog_factor: float = 3.0
    compress_frac: float = 0.0
    aux_weight: float = 0.01


class Trainer:
    """Single-process orchestrator on one device.

    ``jit_step`` (the reference's name, kept) takes a prebuilt step
    function; nothing is jitted here. ``step_fn`` is an attribute a caller
    may replace or wrap. The default ``to_device`` moves a numpy batch to
    ``device`` (``None`` = the card)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        *,
        jit_step: Callable | None = None,
        to_device: Callable[[dict], dict] | None = None,
        device=None,
    ):
        self.cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.dataset = SyntheticLMDataset(data_cfg)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep_checkpoints)
        self.step_fn = jit_step or make_train_step(
            model_cfg, opt_cfg, compress_frac=train_cfg.compress_frac
        )
        self.to_device = to_device or (
            lambda b: {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in b.items()}
        )
        self._preempted = False
        self.history: list[dict] = []

    def _install_preemption_hook(self):
        def handler(signum, frame):
            log.warning("SIGTERM received: checkpoint at next step boundary")
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def run(self, params, opt_state, start_step: int | None = None) -> tuple:
        self._install_preemption_hook()
        # resume from the latest checkpoint when present
        step0 = 0
        latest = self.ckpt.latest_step()
        if start_step is not None:
            step0 = start_step
        elif latest is not None:
            (params, opt_state), extra = self.ckpt.restore((params, opt_state))
            step0 = int(extra.get("next_step", latest + 1))
            log.info("resumed from checkpoint at step %d", step0)
        prefetch = Prefetcher(self.dataset, start_step=step0)
        step_times: list[float] = []
        try:
            for step in range(step0, self.tc.steps):
                t0 = time.perf_counter()
                data_step, batch = prefetch.next()
                assert data_step == step, (data_step, step)
                batch = self.to_device(batch)
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                step_times.append(dt)
                med = float(np.median(step_times[-32:]))
                if len(step_times) > 4 and dt > self.tc.watchdog_factor * med:
                    log.warning(
                        "straggler: step %d took %.2fs (median %.2fs)", step, dt, med
                    )
                self.history.append({"step": step, "loss": loss, "time_s": dt})
                if step % self.tc.log_every == 0:
                    log.info("step %5d loss %.4f (%.2fs/step)", step, loss, dt)
                must_save = (
                    self._preempted
                    or (step + 1) % self.tc.ckpt_every == 0
                    or step + 1 == self.tc.steps
                )
                if must_save:
                    self.ckpt.save(step + 1, (params, opt_state), {"next_step": step + 1})
                if self._preempted:
                    log.warning("exiting after preemption checkpoint (step %d)", step)
                    break
        finally:
            prefetch.close()
        return params, opt_state
