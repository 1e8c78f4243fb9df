"""Decoder-only LM assembly over the block vocabulary.

Layer layout = optional ``first_blocks`` + ``pattern`` repeated
``n_groups`` times (params stacked on a leading group axis, walked by a
Python loop — the reference's ``lax.scan``) + ``tail_blocks``. Block kinds:
``"attn"``, ``"local"`` (windowed attention with a ring cache), ``"moe"``
(attention + the MoE FFN of ``models/moe.py``), ``"rec"`` (RG-LRU + FFN),
``"mlstm"`` and ``"slstm"`` (the xLSTM blocks of ``models/recurrent.py``).

Three entry points: ``forward`` (full sequence, no cache), ``prefill``
(fills the serving cache over a full prompt) and ``decode_step`` (one
token). They return fresh caches; the caches passed in are not modified.
With ``cfg.remat`` set (the default), a pass that takes gradients wraps
each group block in ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps its group body in ``jax.checkpoint``: only the block's
input is kept and the rest is recomputed on the backward pass. Head and
tail blocks run unwrapped, as in the reference; serving (no gradient) and
the sparse engine's path never recompute.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.partition import hint, token_lookup
from repro_torch.models.layers import (
    attention,
    attention_cache_spec,
    attention_specs,
    flash_attention,
    mlp,
    mlp_specs,
    qkv,
    repeat_kv,
    rmsnorm,
    rmsnorm_spec,
)
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.param import (
    ParamSpec,
    init_params,
    stack_specs,
    torch_dtype,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.recurrent import (
    _rglru_in,
    _rglru_out,
    linear_scan,
    mlstm_block,
    mlstm_cache_spec,
    mlstm_specs,
    rglru,
    rglru_cache_spec,
    rglru_specs,
    slstm_block,
    slstm_cache_spec,
    slstm_specs,
)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in ("attn", "local"):
        return {
            "ln1": rmsnorm_spec(d),
            "attn": attention_specs(cfg),
            "ln2": rmsnorm_spec(d),
            "mlp": mlp_specs(cfg),
        }
    if kind == "moe":
        return {
            "ln1": rmsnorm_spec(d),
            "attn": attention_specs(cfg),
            "ln2": rmsnorm_spec(d),
            "moe": moe_specs(cfg),
        }
    if kind == "rec":
        return {
            "ln1": rmsnorm_spec(d),
            "rec": rglru_specs(cfg),
            "ln2": rmsnorm_spec(d),
            "mlp": mlp_specs(cfg),
        }
    if kind == "mlstm":
        return mlstm_specs(cfg)
    if kind == "slstm":
        return slstm_specs(cfg)
    raise ValueError(f"unknown block kind {kind!r}")


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=1.0),
        "head": tuple(block_specs(cfg, k) for k in cfg.first_blocks),
        "groups": tuple(
            stack_specs(block_specs(cfg, k), cfg.n_groups) for k in cfg.pattern
        )
        if cfg.n_groups
        else (),
        "tail": tuple(block_specs(cfg, k) for k in cfg.tail_blocks),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    return specs


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    if kind in ("attn", "moe"):
        return attention_cache_spec(cfg, batch, max_len)
    if kind == "local":
        w = min(cfg.window, max_len)
        spec = attention_cache_spec(cfg, batch, w)
        spec["pos"] = ParamSpec((batch, w), ("batch", None), init="zeros", dtype="int32")
        return spec
    if kind == "rec":
        return rglru_cache_spec(cfg, batch)
    if kind == "mlstm":
        return mlstm_cache_spec(cfg, batch)
    if kind == "slstm":
        return slstm_cache_spec(cfg, batch)
    raise ValueError(f"unknown block kind {kind!r}")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return {
        "head": tuple(block_cache_spec(cfg, k, batch, max_len) for k in cfg.first_blocks),
        "groups": tuple(
            stack_specs(block_cache_spec(cfg, k, batch, max_len), cfg.n_groups)
            for k in cfg.pattern
        )
        if cfg.n_groups
        else (),
        "tail": tuple(block_cache_spec(cfg, k, batch, max_len) for k in cfg.tail_blocks),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A fresh serving cache on ``device`` (``None`` = the card) with its
    initial values: attention K/V, ring positions and recurrent states at
    zeros, the sLSTM normaliser ``n`` at ones."""
    return init_params(cache_specs(cfg, batch, max_len), None, "float32", device)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _local_attention(params, x, cfg, *, positions, cache):
    """Windowed attention; ring cache of width W on the serve path."""
    if cache is None:
        y, _ = attention(params, x, cfg, positions=positions, cache=None, window=cfg.window)
        return y, None
    # ring cache: keep the last W tokens' K/V with absolute positions
    B, T, _ = x.shape
    W = cache["k"].shape[1]
    cd = torch_dtype(cfg.compute_dtype)
    q, k, v = qkv(params, x, cfg, positions)
    keep = min(W, T)
    slots = (positions[:, -keep:] % W).long()
    b_idx = torch.arange(B, device=x.device)[:, None]
    k_all, v_all, pos_all = cache["k"].clone(), cache["v"].clone(), cache["pos"].clone()
    k_all[b_idx, slots] = k[:, -keep:].to(k_all.dtype)
    v_all[b_idx, slots] = v[:, -keep:].to(v_all.dtype)
    pos_all[b_idx, slots] = positions[:, -keep:].to(torch.int32) + 1
    new_cache = {"k": k_all, "v": v_all, "pos": pos_all}
    if T > 1:
        # prefill: attend within the prompt itself (windowed)
        y, _ = attention(params, x, cfg, positions=positions, cache=None, window=cfg.window)
        return y, new_cache
    out = flash_attention(
        q,
        repeat_kv(k_all.to(cd), cfg),
        repeat_kv(v_all.to(cd), cfg),
        q_pos=positions,
        kv_pos=pos_all - 1,
        kv_valid=pos_all > 0,
        window=cfg.window,
        chunk=cfg.attn_chunk,
    )
    y = torch.einsum("bthk,hkd->btd", out, params["wo"].to(cd))
    return y, new_cache


def _rglru_with_state(params, x, cfg, *, cache):
    """RG-LRU with prefill over a carried state (T > 1 with a cache): the
    state folds into the first step as ``a_0 h_0``, and the last step's
    ``h`` is the new state."""
    if cache is None or x.shape[1] == 1:
        return rglru(params, x, cfg, cache=cache)
    a, bx, gb, new_conv = _rglru_in(params, x, cfg, cache["conv"])
    bx = torch.cat([bx[:, :1] + a[:, :1] * cache["h"].float()[:, None], bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    return _rglru_out(params, h, gb, cfg), {"h": h[:, -1], "conv": new_conv}


def apply_block(
    kind: str,
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: dict | None,
    engine=None,
    name: str = "",
):
    """Returns (x, new_cache, (moe_aux, tokens_per_expert)).

    ``engine``/``name`` route this block's FFN matmuls through the sparse
    inference engine (models/sparse_linear.py) under ``{name}.mlp.*`` /
    ``{name}.moe.*`` keys; attention and the recurrences stay dense. A block
    without experts returns ``None`` for the auxiliaries (the reference's
    zeros; eager PyTorch would spend two launches per layer on them)."""
    if kind == "mlstm":
        x, new_cache = mlstm_block(params, x, cfg, cache=cache)
        return x, new_cache, None
    if kind == "slstm":
        x, new_cache = slstm_block(params, x, cfg, cache=cache)
        return x, new_cache, None
    if kind in ("attn", "moe"):
        a, new_cache = attention(
            params["attn"], rmsnorm(x, params["ln1"]), cfg,
            positions=positions, cache=cache, window=0,
        )
    elif kind == "local":
        a, new_cache = _local_attention(
            params["attn"], rmsnorm(x, params["ln1"]), cfg, positions=positions, cache=cache
        )
    elif kind == "rec":
        a, new_cache = _rglru_with_state(params["rec"], rmsnorm(x, params["ln1"]), cfg,
                                         cache=cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    # pinned as the group carry is (DTensor would reduce-scatter the
    # attention's partial sums onto the sequence)
    x = hint(x + a, ("batch", "seq", None))
    h = rmsnorm(x, params["ln2"])
    if kind == "moe":
        y, aux, counts = moe_ffn(params["moe"], h, cfg, engine=engine, name=name)
        return x + y, new_cache, (aux, counts)
    y = mlp(params["mlp"], h, cfg, engine=engine, name=name)
    return x + y, new_cache, None


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens=None, embeds=None, prefix_embeds=None):
    cd = torch_dtype(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(cd)
    else:
        x = token_lookup(params["embed"], tokens).to(cd)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cd), x], dim=1)
    return hint(x, ("batch", "seq", None))


def _zero_aux(cfg, device) -> dict:
    """The MoE auxiliaries of a block without experts: zeros."""
    return {
        "moe_aux": torch.zeros((), dtype=torch.float32, device=device),
        "tokens_per_expert": torch.zeros(max(cfg.n_experts, 1), dtype=torch.float32, device=device),
    }


def _logits(params, cfg, x):
    h = rmsnorm(x, params["final_norm"])
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", h, params["embed"].to(h.dtype))
    else:
        logits = torch.einsum("btd,dv->btv", h, params["lm_head"].to(h.dtype))
    logits = hint(logits.float(), ("batch", None, "vocab"))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _group_params(pstack, n: int) -> list:
    """The ``n`` groups' parameter trees of one stacked pattern position.
    Each leaf is unbound once, so autograd writes the gradient of a stacked
    leaf in one ``stack`` rather than one full-size buffer per group."""
    unbound = [leaf.unbind(0) for leaf in tree_leaves(pstack)]
    return [tree_unflatten(pstack, [u[g] for u in unbound]) for g in range(n)]


def _run_blocks(params, cfg, x, *, positions, cache, unroll_layers, engine=None):
    """Every block in layer order. The auxiliaries ride in the carry
    ``(x, moe_aux, tokens_per_expert)``, as the reference's scan carries
    them: nothing outside the blocks is mutated, so a block recomputed
    under activation checkpointing adds its auxiliaries once."""
    if engine is not None and cfg.n_groups and not unroll_layers:
        # the reference's group scan cannot hold per-layer host-planned
        # kernels; the port keeps its contract so callers behave the same
        raise ValueError(
            "a sparse inference engine dispatches per-layer host-planned "
            "kernels, which cannot live inside the group scan over stacked "
            "params — call with unroll_layers=True to serve sparse"
        )
    new_cache: dict[str, list] = {"head": [], "groups": [], "tail": []}
    zero = _zero_aux(cfg, x.device)
    carry = (x, zero["moe_aux"], zero["tokens_per_expert"])
    # jax.checkpoint(group_fn) of the reference: group blocks keep only
    # their input and recompute the rest on the backward pass. Not on the
    # engine path (inference-only, host-planned kernels), and not where
    # autograd records nothing (serving).
    remat = cfg.remat and engine is None and torch.is_grad_enabled()

    def block(kind, p, carry, c, name, checkpointed=False):
        def run(x, p):
            return apply_block(kind, p, x, cfg, positions=positions, cache=c,
                               engine=engine, name=name)

        x, aux_l, aux_c = carry
        if checkpointed:
            x, nc, block_aux = torch.utils.checkpoint.checkpoint(run, x, p, use_reentrant=False)
        else:
            x, nc, block_aux = run(x, p)
        if block_aux is not None:
            aux_l, aux_c = aux_l + block_aux[0], aux_c + block_aux[1]
        return (x, aux_l, aux_c), nc

    def run_list(kinds, plist, clist, carry, out_key):
        for i, (kind, p, c) in enumerate(zip(kinds, plist, clist)):
            carry, nc = block(kind, p, carry, c, f"{out_key}{i}")
            new_cache[out_key].append(nc)
        return carry

    head_caches = cache["head"] if cache else [None] * len(cfg.first_blocks)
    carry = run_list(cfg.first_blocks, params["head"], head_caches, carry, "head")

    for pi, kind in enumerate(cfg.pattern if cfg.n_groups else ()):
        cstack = cache["groups"][pi] if cache else None
        pstack = params["groups"][pi]
        checkpointed = remat and (carry[0].requires_grad
                                  or any(t.requires_grad for t in tree_leaves(pstack)))
        ncs = []
        for g, p_g in enumerate(_group_params(pstack, cfg.n_groups)):
            c_g = tree_map(lambda a: a[g], cstack) if cstack is not None else None
            carry, nc = block(kind, p_g, carry, c_g, f"g{pi}x{g}", checkpointed)
            carry = (hint(carry[0], ("batch", "seq", None)),) + carry[1:]
            ncs.append(nc)
        new_cache["groups"].append(
            tree_map(lambda *a: torch.stack(a), *ncs) if cache else None
        )

    tail_caches = cache["tail"] if cache else [None] * len(cfg.tail_blocks)
    x, aux_l, aux_c = run_list(cfg.tail_blocks, params["tail"], tail_caches, carry, "tail")

    out_cache = (
        {k: tuple(v) for k, v in new_cache.items()} if cache else None
    )
    return x, out_cache, {"moe_aux": aux_l, "tokens_per_expert": aux_c}


def forward(
    params,
    cfg: ModelConfig,
    *,
    tokens=None,
    embeds=None,
    prefix_embeds=None,
    positions=None,
    unroll_layers: bool = False,
    engine=None,
):
    """Full sequence, no cache. Returns (logits, aux)."""
    x = _embed(params, cfg, tokens, embeds, prefix_embeds)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    x, _, aux = _run_blocks(params, cfg, x, positions=positions, cache=None,
                            unroll_layers=unroll_layers, engine=engine)
    return _logits(params, cfg, x), aux


def prefill(
    params,
    cfg: ModelConfig,
    cache,
    *,
    tokens=None,
    embeds=None,
    prefix_embeds=None,
    unroll_layers: bool = False,
    engine=None,
):
    """Serving prefill: runs the prompt, fills the cache.
    Returns (logits, cache, aux)."""
    x = _embed(params, cfg, tokens, embeds, prefix_embeds)
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    x, cache, aux = _run_blocks(params, cfg, x, positions=positions, cache=cache,
                                unroll_layers=unroll_layers, engine=engine)
    return _logits(params, cfg, x), cache, aux


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens,
    positions,
    *,
    unroll_layers: bool = False,
    engine=None,
):
    """One decoding step. tokens: (B, 1) int; positions: (B, 1) int (the
    absolute index the new token occupies). Returns (logits, cache).

    ``engine`` routes the FFN matmuls through planned SpMV kernels (sparse
    serving); requires ``unroll_layers=True`` when the config has layer
    groups, as in the reference."""
    x = _embed(params, cfg, tokens)
    x, cache, _ = _run_blocks(params, cfg, x, positions=positions, cache=cache,
                              unroll_layers=unroll_layers, engine=engine)
    return _logits(params, cfg, x), cache
