"""Shared transformer layers: RMSNorm, RoPE, chunked-flash GQA attention,
gated FFNs. Plain functions over param trees (models/param.py).

Attention is written flash-style in PyTorch: over ``attn_chunk`` the KV axis
is processed chunk by chunk (a Python loop) with a running (max,
denominator, accumulator) carry, bounding the transient to S*chunk instead
of S^2. It is not a kernel of the reference either (plain ``jnp`` there), so
plain PyTorch is its port. Casts mirror the reference: norms and softmax in
float32, RoPE in float32 and cast back, products in ``compute_dtype``.

Intermediate layouts are pinned to a device mesh with
``dist.partition.hint`` at the reference's sites (the masked scores, the
kv-repeat); outside a ``sharding_context`` and on plain tensors it returns
its argument, so one-device runs compute exactly as without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.partition import hint, local_shards
from repro_torch.models.param import ParamSpec, torch_dtype

NEG_INF = -1e30


# --------------------------------------------------------------------- norms
def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, T, H, dh); positions: (B, T) or (1, T)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- flash attention
def _mask(q_pos, kv_pos, kv_valid, *, window: int, prefix_len: int):
    """(B, Tq, C) boolean mask from positions.

    causal always; ``window`` > 0 limits lookback; ``prefix_len`` > 0 makes
    keys inside the prefix visible to every query (prefix-LM)."""
    qp = q_pos[:, :, None]  # (B, Tq, 1)
    kp = kv_pos[:, None, :]  # (B, 1, C)
    ok = kp <= qp
    if window > 0:
        ok = ok & (kp > qp - window)
    if prefix_len > 0:
        ok = ok | (kp < prefix_len)
    return ok & kv_valid[:, None, :]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kv_valid: torch.Tensor,
    window: int = 0,
    prefix_len: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """q: (B,Tq,H,dh); k/v: (B,S,H,dh) (kv heads already repeated to H).
    Returns (B,Tq,H,dh)."""
    B, Tq, H, dh = q.shape
    S = k.shape[1]
    scale = dh**-0.5
    qf = q.float() * scale

    if Tq == 1 or S <= chunk:
        # single-block path (decode, short sequences)
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
        m = _mask(q_pos, kv_pos, kv_valid, window=window, prefix_len=prefix_len)
        scores = hint(torch.where(m[:, None, :, :], scores, NEG_INF),
                      ("batch", "heads", None, None))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        return out.to(q.dtype)

    if S % chunk:
        # pad the KV axis to the chunk quantum; padded slots are invalid
        pad = chunk - S % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad))
        kv_valid = F.pad(kv_valid, (0, pad))
        S += pad
    m_run = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        k_c, v_c = k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
        msk = _mask(q_pos, kv_pos[:, c0 : c0 + chunk], kv_valid[:, c0 : c0 + chunk],
                    window=window, prefix_len=prefix_len)[:, None, :, :]
        scores = hint(torch.where(msk, scores, NEG_INF), ("batch", "heads", None, None))
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        p = torch.where(msk, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_c.float())
        m_run = m_new
    out = torch.where(
        l_run[..., None] > 0, acc / torch.clamp(l_run[..., None], min=1e-30), 0.0
    )
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B,Tq,H,dh)


# ------------------------------------------------------------- GQA attention
def attention_specs(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv", None)),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv", None)),
        "wo": ParamSpec((h, dh, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_spec(dh)
        specs["k_norm"] = rmsnorm_spec(dh)
    return specs


def _heads_einsum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btd,dhk->bthk", x, w)


def _project(x: torch.Tensor, w: torch.Tensor, heads: str) -> torch.Tensor:
    """x @ w for w: (d, heads, dh), each rank its rows and heads."""
    B, T, _ = x.shape
    return local_shards(_heads_einsum, (x, ("batch", "seq", None)), (w, (None, heads, None)),
                        out=((B, T) + tuple(w.shape[1:]), ("batch", "seq", heads, None)))


def _out_einsum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bthk,hkd->btd", x, w)


def _project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out @ wo for wo: (heads, dh, d): a partial sum over the heads a rank
    holds."""
    B, T = out.shape[:2]
    return local_shards(_out_einsum, (out, ("batch", "seq", "heads", None)),
                        (wo, ("heads", None, None)),
                        out=((B, T, wo.shape[-1]), ("batch", "seq", None)))


def qkv(params: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The projected, normed and rotated q, k, v of ``x``: (B, T, heads, dh)."""
    cd = torch_dtype(cfg.compute_dtype)
    q = _project(x, params["wq"].to(cd), "heads")
    k = _project(x, params["wk"].to(cd), "kv")
    v = _project(x, params["wv"].to(cd), "kv")
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def repeat_kv(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """KV heads repeated to the full head count (GQA), pinned to the model
    axis (kv alone may not divide it; the repeated dim does)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if n_rep == 1:
        return t
    return hint(torch.repeat_interleave(t, n_rep, dim=2), ("batch", None, "heads", None))


def _write_cache(ck, cv, k, v, positions):
    """Copies of the caches with this step's K/V written at ``positions``."""
    b_idx = torch.arange(ck.shape[0], device=ck.device)[:, None]
    pos = positions.long()
    k_all, v_all = ck.clone(), cv.clone()
    k_all[b_idx, pos] = k.to(k_all.dtype)
    v_all[b_idx, pos] = v.to(v_all.dtype)
    return k_all, v_all


def attention(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: dict | None = None,
    window: int = 0,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, T, D); positions: (B, T). With ``cache`` (decode), writes the
    new K/V at ``positions`` and attends over the cache. The cache passed in
    is left as it was: the update goes into a copy, which is returned."""
    B, T, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)
    q, k, v = qkv(params, x, cfg, positions)

    if cache is None:
        kv_pos = positions
        kv_valid = torch.ones((B, T), dtype=torch.bool, device=x.device)
        k_all, v_all = k, v
        new_cache = None
    else:
        # scatter this step's K/V into the cache at `positions`
        S = cache["k"].shape[1]
        # each rank writes its rows
        kv_axes, rows = ("batch", "kv_seq", "kv", None), ("batch", None)
        k_all, v_all = local_shards(
            _write_cache, (cache["k"], kv_axes), (cache["v"], kv_axes), (k, kv_axes),
            (v, kv_axes), (positions, rows), n_out=2,
        )
        new_cache = {"k": k_all, "v": v_all}
        kv_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        kv_valid = kv_pos <= positions[:, -1:]
        k_all = k_all.to(cd)
        v_all = v_all.to(cd)

    def attend(q, k, v, q_pos, kv_pos, kv_valid):
        return flash_attention(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid, window=window,
            prefix_len=cfg.prefix_len if cfg.prefix_lm else 0, chunk=cfg.attn_chunk,
        )

    # each rank its rows and heads
    heads, rows = ("batch", None, "heads", None), ("batch", None)
    out = local_shards(
        attend, (q, heads), (repeat_kv(k_all, cfg), heads), (repeat_kv(v_all, cfg), heads),
        (positions, rows), (kv_pos, rows), (kv_valid, rows),
    )
    return _project_out(out, params["wo"].to(cd)), new_cache


def attention_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    spec = ParamSpec((batch, max_len, kv, dh), ("batch", "kv_seq", "kv", None), init="zeros")
    return {"k": spec, "v": spec}


# ------------------------------------------------------------------ MLP / FFN
def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {
            "w_up": ParamSpec((d, f), ("embed", "ffn")),
            "w_down": ParamSpec((f, d), ("ffn", "embed")),
        }
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp(
    params: dict, x: torch.Tensor, cfg: ModelConfig, *, engine=None, name: str = ""
) -> torch.Tensor:
    """Gated/gelu FFN. With ``engine`` (an ``EngineHandle`` from
    models/sparse_linear.py) every matmul dispatches through the sparse
    inference engine under the key ``{name}.mlp.<w>`` — planned SpMV kernels
    for registered pruned weights, dense contraction otherwise."""
    cd = torch_dtype(cfg.compute_dtype)

    def mm(key, h, w):
        w = w.to(cd)
        if engine is None:
            return torch.einsum("btd,df->btf", h, w)
        return engine.matmul(f"{name}.mlp.{key}", h, w)

    if cfg.mlp_kind == "gelu":
        h = _gelu(mm("w_up", x, params["w_up"]))
        return mm("w_down", h, params["w_down"])
    act = F.silu if cfg.mlp_kind == "swiglu" else _gelu
    g = act(mm("w_gate", x, params["w_gate"]))
    u = mm("w_up", x, params["w_up"])
    return mm("w_down", g * u, params["w_down"])
