"""Mixture-of-experts FFN with Auto-SpMV-selectable dispatch formats.

The router's token->expert assignment is a sparse matrix (rows = experts,
nnz per row = routed tokens). The three dispatch strategies are the paper's
storage formats in disguise (DESIGN.md §3):

* ``dense``  — every expert runs on every token, weighted by the routing
  probabilities (zeros computed, exactly like a dense SpMV). The paper's
  "dense formats are inefficient" baseline; only viable on small configs.
* ``ell``    — one fixed capacity C per expert; token ids are packed into an
  (E, C) index plane with zero-padding — ELLPACK on the assignment matrix.
* ``sell``   — two capacity classes: the hottest E/8 experts get 4C, the
  rest C/2 — a two-slice SELL that cuts padding on skewed routing while
  dropping fewer tokens on hot experts.

``repro_torch.core.features.features_from_assignment_histogram`` turns the
routing histogram into Table-2 features so the run-time mode can pick the
format (``select_dispatch_format``).

Plain PyTorch (the reference's MoE has no Pallas kernel); only the engine
path reaches a kernel, the planned SpMV (B1) of every expert slice. Every
top-k whose tie order decides a result is a stable descending sort, which
keeps ``jax.lax.top_k``'s order: values descending, the lower index first
on ties.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.partition import local_shards
from repro_torch.models.param import ParamSpec, torch_dtype


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype="float32"),
        "w_gate": ParamSpec((e, d, fe), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, fe), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, fe, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "ffn")),
            "w_up": ParamSpec((d, fs), ("embed", "ffn")),
            "w_down": ParamSpec((fs, d), ("ffn", "embed")),
        }
    return specs


def _capacity(T: int, cfg: ModelConfig) -> int:
    c = int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max((c + 7) // 8 * 8, 8)


def _top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values descending, the lower
    index first among equal values (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pack_by_expert(e_flat, t_flat, w_flat, n_rows: int, cap: int, row_of=None):
    """Pack flat (expert, token, weight) assignments into (n_rows, cap)
    planes — the ELL conversion of the assignment matrix. ``row_of`` maps an
    expert id to its output row (identity when None); assignments mapping to
    row -1 or overflowing the capacity land in spill slots and are dropped:
    within one expert, the later ones in flat (token, k) order.
    """
    TK = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s, w_s = e_flat[order], t_flat[order], w_flat[order]
    # position within each expert's run of the sorted assignment list
    first = torch.searchsorted(e_s, e_s, side="left")
    pos = torch.arange(TK, device=e_flat.device) - first
    rows = e_s if row_of is None else row_of[e_s]
    ok = (pos < cap) & (rows >= 0)
    r_c = torch.where(ok, rows, n_rows)  # spill row
    p_c = torch.where(ok, pos, cap)  # spill col
    idx = torch.zeros((n_rows + 1, cap + 1), dtype=torch.long, device=e_flat.device)
    wgt = torch.zeros((n_rows + 1, cap + 1), dtype=w_s.dtype, device=e_flat.device)
    idx[r_c, p_c] = t_s
    wgt[r_c, p_c] = w_s
    return idx[:n_rows, :cap], wgt[:n_rows, :cap]


def _expert_ffn(xg, w_gate, w_up, w_down, cd):
    """xg: (..., E, C, D) grouped tokens; expert-batched gated FFN."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", xg, w_gate.to(cd)))
    u = torch.einsum("...ecd,edf->...ecf", xg, w_up.to(cd))
    return torch.einsum("...ecf,efd->...ecd", g * u, w_down.to(cd))


def _route(params, x, cfg):
    """Router: fp32 softmax, top-k, renormalized weights."""
    logits = torch.einsum("btd,de->bte", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, cfg.top_k)  # (B,T,K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # GShard load-balance loss: E * sum_e fraction_e * prob_e
    K = cfg.top_k
    B = x.shape[0]
    counts = torch.zeros((B, cfg.n_experts), dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, top_e.reshape(B, -1),
                        torch.ones(top_e.reshape(B, -1).shape, device=x.device))
    frac = counts / (x.shape[1] * K)
    # per batch row; the caller takes E * mean over rows (the reference's aux)
    aux_rows = torch.sum(frac * probs.mean(dim=1), dim=-1)
    return top_e, top_w, counts, aux_rows


def _gate_full(top_e, top_w, T: int, E: int, cd) -> torch.Tensor:
    """(B, T, E) dense routing weights: top_w scattered at top_e, 0 elsewhere."""
    B = top_e.shape[0]
    gate = torch.zeros((B, T, E), dtype=cd, device=top_e.device)
    return gate.scatter_(2, top_e, top_w.to(cd))


def _dispatch_one(xb, eb, wb, cb, params, cfg, cd, dispatch):
    """One batch row of the ``ell`` / ``sell`` dispatch: (T, D) -> (T, D)."""
    T, D = xb.shape
    E, K = cfg.n_experts, cfg.top_k
    t_flat = torch.arange(T, device=xb.device)[:, None].expand(T, K).reshape(-1)
    e_flat = eb.reshape(-1)
    w_flat = wb.reshape(-1).to(cd)
    all_ids = torch.arange(E, device=xb.device)
    if dispatch == "ell":
        cap = _capacity(T, cfg)
        idx, wgt = _pack_by_expert(e_flat, t_flat, w_flat, E, cap)
        buckets = [(all_ids, idx, wgt)]
    else:
        base = _capacity(T, cfg)
        e_hot = max(E // 8, 1)
        cap_hot, cap_cold = 4 * base, max(base // 2, 8)
        hot_ids = _top_k(cb, e_hot)[1]  # integer counts: ties are common
        rank = torch.full((E,), -1, dtype=torch.long, device=xb.device)
        rank[hot_ids] = torch.arange(e_hot, device=xb.device)
        idx_h, wgt_h = _pack_by_expert(e_flat, t_flat, w_flat, e_hot, cap_hot, row_of=rank)
        cold_row = torch.where(rank >= 0, -1, all_ids)
        idx_c, wgt_c = _pack_by_expert(e_flat, t_flat, w_flat, E, cap_cold, row_of=cold_row)
        buckets = [(hot_ids, idx_h, wgt_h), (all_ids, idx_c, wgt_c)]
    yb = torch.zeros((T, D), dtype=cd, device=xb.device)
    for ids, idx, wgt in buckets:
        xg = xb[idx]  # (rows, cap, D)
        h = _expert_ffn(xg, params["w_gate"][ids], params["w_up"][ids],
                        params["w_down"][ids], cd)
        yb.index_add_(0, idx.reshape(-1), (h * wgt[..., None]).reshape(-1, D))
    return yb


def moe_ffn(
    params: dict, x: torch.Tensor, cfg: ModelConfig, *, engine=None, name: str = ""
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y, aux_loss, tokens_per_expert).

    With ``engine`` (sparse serving) every expert's pruned FFN slices run as
    planned SpMV matmuls under ``{name}.moe.<w>.<e>`` keys, weighted by the
    same dense gate the ``dispatch_format="dense"`` baseline uses — the two
    paths are exactly the same math, so sparse-served MoE logits match the
    dense reference. Requires ``dispatch_format="dense"``: ell/sell drop
    capacity-overflow tokens, which the per-expert loop does not reproduce.
    """
    cd = torch_dtype(cfg.compute_dtype)
    dispatch = cfg.dispatch_format
    if engine is not None and dispatch != "dense":
        raise ValueError(
            "sparse-expert serving needs dispatch_format='dense' (the gate-"
            f"masked per-expert path); got {dispatch!r} — override the config "
            "with .replace(dispatch_format='dense') when attaching an engine"
        )
    # each rank routes its rows, then runs them through its slice of every
    # expert's ffn dim (a partial sum over the ranks that split it)
    rows = ("batch", None, None)
    top_e, top_w, counts, aux_rows = local_shards(
        lambda x, router: _route({"router": router}, x, cfg),
        (x, rows), (params["router"], (None, None)), n_out=4,
    )
    y = local_shards(
        lambda x, e, w, c, *ws: _routed_ffn(dict(zip(_EXPERT_W, ws)), x, e, w, c, cfg, cd,
                                            engine, name),
        (x, rows), (top_e, rows), (top_w, rows), (counts, ("batch", None)),
        (params["w_gate"], ("experts", None, "ffn")), (params["w_up"], ("experts", None, "ffn")),
        (params["w_down"], ("experts", "ffn", None)),
    )
    aux = cfg.n_experts * torch.mean(aux_rows)
    if cfg.n_shared_experts:
        sh = params["shared"]
        if engine is None:
            dt = torch.promote_types(x.dtype, cd)  # the reference's einsum promotion
            xs = x.to(dt)
            g = F.silu(torch.einsum("btd,df->btf", xs, sh["w_gate"].to(cd).to(dt)))
            u = torch.einsum("btd,df->btf", xs, sh["w_up"].to(cd).to(dt))
            y = y + torch.einsum("btf,fd->btd", g * u, sh["w_down"].to(cd).to(dt))
        else:
            g = F.silu(
                engine.matmul(f"{name}.moe.shared.w_gate", x, sh["w_gate"].to(cd))
            )
            u = engine.matmul(f"{name}.moe.shared.w_up", x, sh["w_up"].to(cd))
            y = y + engine.matmul(
                f"{name}.moe.shared.w_down", g * u, sh["w_down"].to(cd)
            )
    return y.to(x.dtype), aux, counts.sum(0)


_EXPERT_W = ("w_gate", "w_up", "w_down")


def _routed_ffn(params, x, top_e, top_w, counts, cfg, cd, engine, name):
    """The routed experts' output for x: (B, T, D), given its routing."""
    B, T, D = x.shape
    E = cfg.n_experts
    dispatch = cfg.dispatch_format
    if engine is not None:
        gate_full = _gate_full(top_e, top_w, T, E, cd)
        xc = x.to(cd)
        y = torch.zeros((B, T, D), dtype=cd, device=x.device)
        for e in range(E):
            g = F.silu(
                engine.matmul(f"{name}.moe.w_gate.{e}", xc, params["w_gate"][e].to(cd))
            )
            u = engine.matmul(f"{name}.moe.w_up.{e}", xc, params["w_up"][e].to(cd))
            h = engine.matmul(f"{name}.moe.w_down.{e}", g * u, params["w_down"][e].to(cd))
            y = y + h * gate_full[..., e : e + 1]
    elif dispatch == "dense":
        if T * E * cfg.d_ff_expert > (1 << 28):
            raise ValueError(
                "dense dispatch on a config this large would materialize "
                f"{T}x{E}x{cfg.d_ff_expert} activations; use ell/sell"
            )
        # every expert computes every token (the dense-format baseline)
        xe = x[:, None, :, :].expand(B, E, T, D).to(cd)
        h = _expert_ffn(xe, params["w_gate"], params["w_up"], params["w_down"], cd)  # (B,E,T,D)
        gate_full = _gate_full(top_e, top_w, T, E, cd)
        y = torch.einsum("betd,bte->btd", h, gate_full)
    elif dispatch in ("ell", "sell"):
        xc = x.to(cd)
        y = torch.stack([
            _dispatch_one(xc[b], top_e[b], top_w[b], counts[b], params, cfg, cd, dispatch)
            for b in range(B)
        ])
    else:
        raise ValueError(f"unknown dispatch format {dispatch!r}")
    return y


def select_dispatch_format(tokens_per_expert) -> str:
    """Auto-SpMV run-time mode for MoE: pick the dispatch format from the
    routing histogram's sparsity features (host-side, between-step
    decision, like the paper's kernel selection)."""
    from repro_torch.core.features import features_from_assignment_histogram

    if isinstance(tokens_per_expert, torch.Tensor):
        tokens_per_expert = tokens_per_expert.detach().cpu().numpy()
    f = features_from_assignment_histogram(np.asarray(tokens_per_expert))
    # skewed routing (low ELL efficiency) -> SELL two-slice dispatch
    if f.ell_ratio < 0.5 and f.std_nnz > 0.5 * max(f.avg_nnz, 1e-9):
        return "sell"
    return "ell"
