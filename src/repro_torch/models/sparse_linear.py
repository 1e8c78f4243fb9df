"""Sparse LM inference: route pruned weight matmuls through AutoSpmvSession.

The paper tunes one kernel per matrix per objective; an LM forward pass is a
fleet of such matrices (the FFN up/gate/down projections) that never change
between decode steps. ``SparseInferenceEngine`` is the bridge:

* ``register`` wraps a magnitude-pruned weight matrix as a ``SparseLinear``
  (transposed to the SpMV orientation, fingerprinted, density-gated);
* ``matmul`` is the single dispatch point model code calls — it routes the
  per-token vectors through a ``session.serve_optimize``-planned kernel (on
  the session tuner's device: the CSR kernel of compile-time mode), or
  falls back to a dense contraction when the matrix is too dense,
  unregistered, or the token count exceeds the SpMV window;
* exactly **one plan per (weight fingerprint, objective)** is computed for
  the lifetime of the engine — every decode step of every request reuses it
  (the solver-style amortization contract, assertable via session counters).

PyTorch runs eagerly, so nothing here is traced: ``plan_all`` plans every
matrix up front (the serving path calls it before a tick uses an
objective); a first ``matmul`` plans lazily otherwise. The engine still
requires ``unroll_layers`` in ``models.model._run_blocks``, as the
reference does, so both packages accept the same calls.

SLO routing: serving traffic carries an objective *class* per request
(``Request.slo``); ``SLO_OBJECTIVES`` maps the classes onto the paper's four
objectives and ``SLO_PRIORITY`` decides which class a shared decode batch is
served under (latency-critical dominates). ``obs/energy.py`` cells are keyed
by the request's own class, so mixed traffic shows who burned the joules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.ops import compile_spmv, matrix_fingerprint
from repro_torch.models.param import tree_map
from repro_torch.obs.trace import get_tracer, span as _span
from repro_torch.optim.compress import magnitude_prune
from repro_torch.utils.logging import get_logger

log = get_logger("models.sparse_linear")
_TRACER = get_tracer()

# Request SLO class -> the paper objective the planner optimizes for it.
SLO_OBJECTIVES = {
    "latency-critical": "latency",
    "power-capped": "power",
    "balanced": "efficiency",
    "energy-saving": "energy",
}

# Shared decode batches run under ONE objective per tick: the highest-
# priority class among the occupied slots wins (an energy-saving request
# sharing a tick with a latency-critical one is served latency-optimal and
# accounted under its own class).
SLO_PRIORITY = ("latency-critical", "power-capped", "balanced", "energy-saving")


def slo_objective(slo: str) -> str:
    """Map an SLO class to its paper objective, with a helpful error."""
    try:
        return SLO_OBJECTIVES[slo]
    except KeyError:
        raise ValueError(
            f"unknown SLO class {slo!r}; expected one of {sorted(SLO_OBJECTIVES)}"
        ) from None


@dataclass(frozen=True)
class SparseLinear:
    """One registered weight matrix in SpMV orientation.

    The model computes ``y = x @ W`` with ``W: (d_in, d_out)``; the SpMV
    kernels compute ``A @ v``, so the engine stores ``A = W.T`` and serves
    each token row as one SpMV: ``y_i = A @ x_i``.
    """

    name: str
    weight_t: np.ndarray  # (d_out, d_in) — the SpMV operand W.T, on the host
    fingerprint: str
    density: float
    d_in: int
    d_out: int
    spmv_eligible: bool  # False: always served by the dense fallback


@dataclass
class EngineStats:
    """What the engine planned vs. what it routed densely (matmul counters
    count calls of ``matmul``, one per layer and weight per decode step)."""

    registered: int = 0
    spmv_layers: int = 0  # registered AND below the density threshold
    plans: int = 0  # one per (fingerprint, objective), engine lifetime
    spmv_matmuls: int = 0
    dense_fallbacks: int = 0
    fp32_recompiles: int = 0

    def as_dict(self) -> dict:
        return {
            "registered": self.registered,
            "spmv_layers": self.spmv_layers,
            "plans": self.plans,
            "spmv_matmuls": self.spmv_matmuls,
            "dense_fallbacks": self.dense_fallbacks,
            "fp32_recompiles": self.fp32_recompiles,
        }


@dataclass(frozen=True)
class EngineHandle:
    """An engine bound to one objective — what model code receives.

    One ``BatchedServer`` holds one decode callable per objective, each
    closing over its handle, against the same shared engine/session."""

    engine: "SparseInferenceEngine"
    objective: str

    def matmul(self, name: str, x, w):
        return self.engine.matmul(name, x, w, self.objective)


class SparseInferenceEngine:
    """One shared execution engine for every sparse matmul in inference.

    Parameters
    ----------
    session:
        The shared ``AutoSpmvSession``; plans and kernels flow through its
        feature-bucketed cache and the process-wide kernel memo, on its
        tuner's device.
    density_threshold:
        Registered matrices denser than this are served by the dense
        fallback — SpMV on a half-dense matrix loses to a dense product.
    max_spmv_tokens:
        Token-count ceiling for the SpMV route. Decode steps batch a handful
        of per-token vectors; prefill traffic (tens to thousands of tokens)
        stays dense, where it is numerically identical because the weights
        themselves are pruned.
    force_fp32:
        Recompile a plan whose served schedule accumulates in bf16 with
        ``accum_dtype="float32"`` (same format/identity) so sparse-served
        logits match the dense fp32 reference — the solver-path guard.
    """

    def __init__(
        self,
        session,
        *,
        density_threshold: float = 0.5,
        max_spmv_tokens: int = 8,
        force_fp32: bool = True,
    ):
        self.session = session
        self.density_threshold = float(density_threshold)
        self.max_spmv_tokens = int(max_spmv_tokens)
        self.force_fp32 = force_fp32
        self.stats = EngineStats()
        self._by_name: dict[str, SparseLinear] = {}
        # (fingerprint, objective) -> (ServedPlan, kernel): THE amortization
        # dict — serve_optimize runs exactly once per key, ever.
        self._plans: dict[tuple[str, str], tuple[object, object]] = {}

    # --------------------------------------------------------- registration
    def register(self, name: str, weight) -> SparseLinear:
        """Register a pruned ``(d_in, d_out)`` weight matrix (numpy array or
        tensor) under ``name``.

        Re-registering a name replaces the entry (plans are keyed by content
        fingerprint, so an identical re-registration costs nothing)."""
        with _span("engine.register", layer=name):
            if isinstance(weight, torch.Tensor):
                weight = weight.detach().float().cpu().numpy()
            w = np.ascontiguousarray(np.asarray(weight, dtype=np.float32))
            if w.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D weight, got shape {w.shape}")
            a = np.ascontiguousarray(w.T)
            density = float(np.count_nonzero(a)) / max(a.size, 1)
            eligible = 0.0 < density <= self.density_threshold
            layer = SparseLinear(
                name=name,
                weight_t=a,
                fingerprint=matrix_fingerprint(a),
                density=density,
                d_in=a.shape[1],
                d_out=a.shape[0],
                spmv_eligible=eligible,
            )
        if name not in self._by_name:
            self.stats.registered += 1
            if eligible:
                self.stats.spmv_layers += 1
        self._by_name[name] = layer
        return layer

    def layer(self, name: str) -> SparseLinear | None:
        return self._by_name.get(name)

    def bind(self, objective: str) -> EngineHandle:
        return EngineHandle(self, objective)

    # ---------------------------------------------------------------- plans
    def plan(self, name: str, objective: str):
        """The (plan, kernel) pair for one registered matrix — computed via
        ``session.serve_optimize`` on first sight of (fingerprint,
        objective), reused for the engine's lifetime afterwards."""
        layer = self._by_name[name]
        key = (layer.fingerprint, objective)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        with _span("engine.plan", layer=name, objective=objective):
            served = self.session.serve_optimize(
                layer.weight_t, objective, fingerprint=layer.fingerprint
            )
            kernel = served.kernel
            if self.force_fp32 and served.schedule.accum_dtype != "float32":
                kernel = compile_spmv(
                    layer.weight_t,
                    served.fmt,
                    served.schedule.replace(accum_dtype="float32"),
                    device=self.session.tuner.device,
                    memo_key=layer.fingerprint,
                )
                self.stats.fp32_recompiles += 1
        self._plans[key] = (served, kernel)
        self.stats.plans = len(self._plans)
        log.info(
            "planned %s for %s: fmt=%s density=%.3f (%d plans total)",
            name, objective, served.fmt, layer.density, self.stats.plans,
        )
        return served, kernel

    def plan_all(self, objective: str) -> int:
        """Plan every SpMV-eligible registered matrix for one objective, so
        that decode ticks only ever see warm plans (planning converts the
        matrix on the host and copies it to the device). Returns how many
        matrices are eligible."""
        n = 0
        for name, layer in self._by_name.items():
            if layer.spmv_eligible:
                self.plan(name, objective)
                n += 1
        return n

    # --------------------------------------------------------------- matmul
    def matmul(self, name: str, x: torch.Tensor, w: torch.Tensor, objective: str):
        """``x @ w`` with ``x: (..., d_in)`` — the single dispatch point.

        Routes through the planned SpMV kernel when ``name`` is registered,
        SpMV-eligible, and the token count fits the SpMV window: one SpMV
        per token, in float32, cast back to ``x.dtype`` (the reference's
        per-token loop; there is no multi-vector route here). Otherwise
        contracts densely with the passed param leaf ``w`` (which holds the
        same pruned values, so both routes agree numerically). With the
        tracer on, one ``engine.matmul`` span (``layer``, ``tokens``,
        ``route``) around either route."""
        layer = self._by_name.get(name)
        tokens = int(np.prod(x.shape[:-1]))
        dense = layer is None or not layer.spmv_eligible or tokens > self.max_spmv_tokens
        if not _TRACER.enabled:
            return self._matmul(name, layer, x, w, objective, tokens, dense)
        with _TRACER.span("engine.matmul", layer=name, tokens=tokens,
                          route="dense" if dense else "spmv"):
            return self._matmul(name, layer, x, w, objective, tokens, dense)

    def _matmul(self, name, layer, x, w, objective, tokens: int, dense: bool):
        if dense:
            if layer is not None:
                self.stats.dense_fallbacks += 1
            return torch.einsum("...d,df->...f", x, w)
        _, kernel = self.plan(name, objective)
        flat = x.reshape(-1, layer.d_in)
        ys = [kernel(flat[i].to(torch.float32)) for i in range(tokens)]
        y = torch.stack(ys).reshape(*x.shape[:-1], layer.d_out)
        self.stats.spmv_matmuls += 1
        return y.to(x.dtype)

    # ------------------------------------------------------------ accounting
    def plans_for(self, objective: str) -> list:
        return [p for (_, obj), (p, _) in self._plans.items() if obj == objective]

    def format_mix(self, objective: str) -> str:
        """The served formats under one objective, e.g. ``"csr"`` or
        ``"csr+ell"`` — the energy-cell fmt label for LM ticks."""
        fmts = sorted({p.fmt for p in self.plans_for(objective)})
        return "+".join(fmts) if fmts else "dense"

    def modeled_objectives(self, objective: str) -> dict:
        """Summed model estimates across this objective's plans — the
        modeled per-token cost of one pass over every planned matrix.
        Power/efficiency are re-derived so the triple stays consistent with
        how ``EnergyAccountant`` recovers useful work."""
        plans = self.plans_for(objective)
        lat = sum(float(p.predicted.get("latency") or 0.0) for p in plans)
        energy = sum(float(p.predicted.get("energy") or 0.0) for p in plans)
        useful = sum(
            float(p.predicted.get("efficiency") or 0.0)
            * float(p.predicted.get("power") or 0.0)
            * float(p.predicted.get("latency") or 0.0)
            * 1e6
            for p in plans
        )
        power = energy / lat if lat > 0 else 0.0
        eff = useful / (lat * power * 1e6) if lat > 0 and power > 0 else 0.0
        return {"latency": lat, "energy": energy, "power": power, "efficiency": eff}

    def summary(self) -> dict:
        objectives = sorted({obj for (_, obj) in self._plans})
        return {
            "registered": self.stats.registered,
            "spmv_layers": self.stats.spmv_layers,
            "stats": self.stats.as_dict(),
            "objectives": {
                obj: {
                    "plans": len(self.plans_for(obj)),
                    "formats": self.format_mix(obj),
                }
                for obj in objectives
            },
        }


# ---------------------------------------------------------------- pruning
def ffn_block_names(cfg) -> list[tuple[str, str]]:
    """(block name, kind) pairs in the canonical ``_run_blocks`` naming:
    ``head{i}`` / ``g{pattern_index}x{group}`` / ``tail{i}``."""
    out = [(f"head{i}", k) for i, k in enumerate(cfg.first_blocks)]
    for pi, kind in enumerate(cfg.pattern if cfg.n_groups else ()):
        out.extend((f"g{pi}x{g}", kind) for g in range(cfg.n_groups))
    out.extend((f"tail{i}", k) for i, k in enumerate(cfg.tail_blocks))
    return out


def prune_model_ffns(params, cfg, engine: SparseInferenceEngine, density: float):
    """Magnitude-prune every FFN weight matrix in ``params`` to ``density``
    and register the pruned matrices with ``engine`` under the canonical
    block names ``models.model._run_blocks`` threads to ``mlp``/``moe_ffn``.

    Prunes dense-FFN ``w_gate``/``w_up``/``w_down``, each MoE expert's
    slices (``{name}.moe.{w}.{e}``) and shared-expert FFNs
    (``{name}.moe.shared.{w}``); attention, router, embeddings and norms are
    untouched. Pruning happens in fp32 on the host and the stored leaf is
    cast back to its original dtype, with the engine registering exactly
    the cast-back values — so the dense fallback and the SpMV route see
    identical weights. Returns a new params tree whose pruned leaves are
    tensors on the params' own device (prefill and the dense fallback read
    them there); a stacked ``(E, d, f)`` expert leaf stays one tensor.
    """

    def prune_leaf(w: torch.Tensor, name: str) -> torch.Tensor:
        pruned, _ = magnitude_prune(w.detach().float().cpu().numpy(), density)
        stored = torch.from_numpy(pruned).to(w.dtype)
        engine.register(name, stored.float().numpy())
        return stored.to(w.device)

    def prune_block(block, name):
        block = dict(block)
        if "mlp" in block:
            sub = dict(block["mlp"])
            for k in ("w_gate", "w_up", "w_down"):
                if k in sub:
                    sub[k] = prune_leaf(sub[k], f"{name}.mlp.{k}")
            block["mlp"] = sub
        if "moe" in block:
            moe = dict(block["moe"])
            for k in ("w_gate", "w_up", "w_down"):
                stacked = moe[k]
                moe[k] = torch.stack(
                    [prune_leaf(stacked[e], f"{name}.moe.{k}.{e}")
                     for e in range(stacked.shape[0])]
                )
            if "shared" in moe:
                sh = dict(moe["shared"])
                for k in ("w_gate", "w_up", "w_down"):
                    if k in sh:
                        sh[k] = prune_leaf(sh[k], f"{name}.moe.shared.{k}")
                moe["shared"] = sh
            block["moe"] = moe
        return block

    params = dict(params)
    params["head"] = tuple(
        prune_block(b, f"head{i}") for i, b in enumerate(params["head"])
    )
    new_groups = []
    for pi, pstack in enumerate(params["groups"]):
        layers = [
            prune_block(tree_map(lambda a: a[g], pstack), f"g{pi}x{g}")
            for g in range(cfg.n_groups)
        ]
        new_groups.append(tree_map(lambda *xs: torch.stack(xs), *layers))
    params["groups"] = tuple(new_groups)
    params["tail"] = tuple(
        prune_block(b, f"tail{i}") for i, b in enumerate(params["tail"])
    )
    log.info(
        "pruned FFN weights to density %.3f: %d matrices registered, %d SpMV-eligible",
        density, engine.stats.registered, engine.stats.spmv_layers,
    )
    return params
