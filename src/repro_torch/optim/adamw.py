"""AdamW from scratch, as the reference writes it.

Decoupled weight decay, global-norm gradient clipping, optional
low-precision (bf16) first/second moments for the largest archs — the
moment dtype is the dominant optimizer-memory knob. The update runs under
``torch.no_grad()``: the returned parameters carry no autograd history from
one step to the next. Every number stays on the parameters' device (the
step counter, the rate, the norm), so an update never waits for it.

Trees are walked by key from the parameters' own structure (``tree_map``),
so params, grads and the moments may come from differently ordered dicts;
the global norm sums its per-leaf squares in the parameters' order, which
differs from the reference's sorted-key order only in the last bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.param import torch_dtype, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "float32"  # bf16 halves optimizer memory

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.full((), self.learning_rate, dtype=torch.float32, device=step.device)


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` and a 0-d int32 step counter, on
    the parameters' device."""
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_adamw(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig
) -> tuple[Any, dict, dict]:
    """One AdamW update. Returns (params, state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip_norm > 0:
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    else:
        grads = tree_map(lambda g: g.float(), grads)
    lr = cfg.lr_at(step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    sdt = torch_dtype(cfg.state_dtype)

    def upd(p, g, m, v):
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(sdt), v32.to(sdt)

    # walked by key over the params' structure; a tuple-returning tree_map
    # would be ambiguous (tuples are structure), so collect and unflatten
    results: list = []
    tree_map(lambda *a: results.append(upd(*a)), params, grads, state["m"], state["v"])
    return (
        tree_unflatten(params, [r[0] for r in results]),
        {"m": tree_unflatten(params, [r[1] for r in results]),
         "v": tree_unflatten(params, [r[2] for r in results]), "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
