"""Recurrent sequence mixers: RG-LRU (RecurrentGemma), mLSTM + sLSTM (xLSTM).

The reference runs these as XLA scans, not as Pallas kernels, so plain
PyTorch is their port, as a plain matrix product is:

* RG-LRU is a diagonal linear recurrence ``h_t = a_t h_{t-1} + b_t``. The
  reference's ``jax.lax.associative_scan`` becomes a log-depth doubling
  scan over T with the same combine, ``(a1 a2, b1 a2 + b2)``, in float32
  (``linear_scan``). A ``cumprod`` of ``a`` would divide by products that
  underflow over long T (``a`` ~ 0.98 a step); the doubling scan never
  divides.
* mLSTM uses the chunkwise-parallel form: intra-chunk quadratic attention
  with decay, plus the state carried from chunk to chunk. The reference
  combines chunk summaries with an associative scan; here a loop over the
  ``ceil(T / mlstm_chunk)`` chunks carries it, the initial state included.
* sLSTM's recurrence is sequential (the xLSTM paper says as much); the
  reference's ``lax.scan`` over T is a loop over T here.

Decode paths update O(1)-size states. Functions take and return tensors on
one device; they never modify the cache passed in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _gelu, rmsnorm
from repro_torch.models.param import ParamSpec, torch_dtype

# ---------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


def rglru_specs(cfg: ModelConfig) -> dict:
    d, r, k = cfg.d_model, cfg.rnn_dim, cfg.conv1d_size
    h = cfg.n_heads
    rh = r // h
    return {
        "w_in": ParamSpec((d, r), ("embed", "rnn")),
        "w_gate": ParamSpec((d, r), ("embed", "rnn")),
        "conv_w": ParamSpec((k, r), (None, "rnn")),
        "conv_b": ParamSpec((r,), (None,), init="zeros"),
        "wa": ParamSpec((h, rh, rh), (None, None, None)),  # block-diag recurrence gate
        "ba": ParamSpec((r,), (None,), init="zeros"),
        "wx": ParamSpec((h, rh, rh), (None, None, None)),  # block-diag input gate
        "bx": ParamSpec((r,), (None,), init="zeros"),
        "lam": ParamSpec((r,), (None,), init="ones"),  # a = sigmoid(lam+4) ~ .98
        "w_out": ParamSpec((r, d), ("rnn", "embed")),
    }


def _causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv along T. x: (B,T,R), w: (k,R).
    With ``state`` (B,k-1,R), the last k-1 inputs of the previous call are
    the left context (decode, or prefill after a prefix); returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        left = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        left = state.to(x.dtype)
    xp = torch.cat([left, x], dim=1)
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    T = x.shape[1]
    y = sum(xp[:, i : i + T, :] * w[i] for i in range(k)) + b
    return y.to(x.dtype), new_state


def _lru_gates(params, xc, cfg):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32 (B,T,R).

    ``F.softplus`` turns linear above 20 where ``jax.nn.softplus`` does not;
    in float32 ``log1p(exp(-x))`` is below half an ulp of x there, so the two
    round alike (tests/test_torch_recurrent.py holds them together)."""
    h = cfg.n_heads
    B, T, R = xc.shape
    xh = xc.reshape(B, T, h, R // h).float()
    r_t = torch.sigmoid(
        torch.einsum("bthr,hrs->bths", xh, params["wa"].float()).reshape(B, T, R)
        + params["ba"].float()
    )
    i_t = torch.sigmoid(
        torch.einsum("bthr,hrs->bths", xh, params["wx"].float()).reshape(B, T, R)
        + params["bx"].float()
    )
    # a_t = exp(-8 * softplus(lam) * r_t)   (Griffin eq. 4, c = 8)
    a = torch.exp(-8.0 * F.softplus(params["lam"].float()) * r_t)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i_t * xc.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t with h_{-1} = 0, along axis 1.

    Doubling (Hillis-Steele) over the reference's associative combine
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``: after the step of offset
    d every t holds the composition of steps (t - 2d, t]; log2(T) steps of
    elementwise work, no division."""
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], b_prev * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return b


def _rglru_in(params, x, cfg, conv_state):
    """The projections, conv and gates shared by every RG-LRU path:
    (a, b, gate branch, new conv state)."""
    cd = torch_dtype(cfg.compute_dtype)
    xb = torch.einsum("btd,dr->btr", x, params["w_in"].to(cd))
    gb = torch.einsum("btd,dr->btr", x, params["w_gate"].to(cd))
    xc, new_conv = _causal_conv1d(xb, params["conv_w"].to(cd), params["conv_b"].to(cd),
                                  conv_state)
    a, bx = _lru_gates(params, xc, cfg)
    return a, bx, gb, new_conv


def _rglru_out(params, h, gb, cfg):
    cd = torch_dtype(cfg.compute_dtype)
    y = (h.to(cd) * _gelu(gb)).to(cd)
    return torch.einsum("btr,rd->btd", y, params["w_out"].to(cd))


def rglru(params, x, cfg: ModelConfig, *, cache=None):
    """Full RG-LRU residual-block mixer. x: (B,T,D).
    cache: {"h": (B,R), "conv": (B,k-1,R)} for decode, which reads only the
    first step's gates (T == 1); ``models.model._rglru_with_state`` is the
    prefill with a carried state."""
    a, bx, gb, new_conv = _rglru_in(params, x, cfg, None if cache is None else cache["conv"])
    if cache is None:
        h = linear_scan(a, bx)  # the diagonal recurrence over T
        new_cache = None
    else:
        h = a[:, 0] * cache["h"].float() + bx[:, 0]
        new_cache = {"h": h, "conv": new_conv}
        h = h[:, None, :]
    return _rglru_out(params, h, gb, cfg), new_cache


def rglru_cache_spec(cfg: ModelConfig, batch: int) -> dict:
    r, k = cfg.rnn_dim, cfg.conv1d_size
    return {
        "h": ParamSpec((batch, r), ("batch", "rnn"), init="zeros", dtype="float32"),
        "conv": ParamSpec((batch, k - 1, r), ("batch", None, "rnn"), init="zeros"),
    }


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM) — chunkwise-parallel, sigma-gated variant
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    m = 2 * d  # projection factor 2 (xLSTM-1.3B)
    h = cfg.n_heads
    dh = m // h
    return {
        "ln": ParamSpec((d,), (None,), init="ones"),
        "w_up": ParamSpec((d, 2 * m), ("embed", "ffn")),  # [mixer | gate] branches
        "wq": ParamSpec((m, h, dh), ("ffn", "heads", None)),
        "wk": ParamSpec((m, h, dh), ("ffn", "heads", None)),
        "wv": ParamSpec((m, h, dh), ("ffn", "heads", None)),
        "w_if": ParamSpec((m, 2 * h), ("ffn", None)),  # input/forget gates per head
        "out_norm": ParamSpec((m,), (None,), init="ones"),
        "w_down": ParamSpec((m, d), ("ffn", "embed")),
    }


def _mlstm_core(q, k, v, i_gate, f_gate, chunk: int, state=None):
    """Chunkwise linear attention with per-head scalar decay.

    q/k/v: (B,T,H,dh); i_gate/f_gate: (B,T,H) in (0,1).
    Returns (out (B,T,H,dh) float32, final_state (C, n) float32).
    """
    B, T, H, dh = q.shape
    scale = dh**-0.5
    q = q.float() * scale
    k = k.float()
    v = v.float()
    i_gate, f_gate = i_gate.float(), f_gate.float()
    ki = k * i_gate[..., None]  # input gate scales the written key
    log_f = torch.log(torch.clamp(f_gate, min=1e-9))

    if state is not None and T == 1:  # decode step: the recurrent form
        C, n = state
        C = f_gate[:, 0, :, None, None] * C + torch.einsum("bhk,bhv->bhkv", ki[:, 0], v[:, 0])
        n = f_gate[:, 0, :, None] * n + ki[:, 0]
        num = torch.einsum("bhk,bhkv->bhv", q[:, 0], C)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", q[:, 0], n))[..., None], min=1.0)
        return (num / den)[:, None], (C, n)

    T_orig = T
    if T % chunk:
        # pad with identity steps: f=1 (log f = 0, no decay), i=0 (nothing written)
        pad = chunk - T % chunk
        padT = lambda a: F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))  # noqa: E731
        q, k, v, ki, log_f = padT(q), padT(k), padT(v), padT(ki), padT(log_f)
        T += pad
    nc = T // chunk
    qc = q.reshape(B, nc, chunk, H, dh)
    kc = ki.reshape(B, nc, chunk, H, dh)
    vc = v.reshape(B, nc, chunk, H, dh)
    cums = torch.cumsum(log_f.reshape(B, nc, chunk, H), dim=2)  # inclusive log-decay
    total = cums[:, :, -1, :]  # (B,nc,H)

    # ---- chunk summaries: S_c = sum_s exp(total - cums_s) k_s v_s^T
    wk = torch.exp(total[:, :, None, :] - cums)  # decay from step s to chunk end
    S_c = torch.einsum("bnch,bnchk,bnchv->bnhkv", wk, kc, vc)
    n_c = torch.einsum("bnch,bnchk->bnhk", wk, kc)

    # ---- inter-chunk recurrence: the state before each chunk, carried
    # from the initial state (zeros without one) through every chunk
    A = torch.exp(total)
    if state is None:
        S = torch.zeros_like(S_c[:, 0])
        n = torch.zeros_like(n_c[:, 0])
    else:
        S, n = state[0].float(), state[1].float()
    S_prev, n_prev = [], []
    for c in range(nc):
        S_prev.append(S)
        n_prev.append(n)
        S = S * A[:, c, :, None, None] + S_c[:, c]
        n = n * A[:, c, :, None] + n_c[:, c]
    S_prev = torch.stack(S_prev, dim=1)
    n_prev = torch.stack(n_prev, dim=1)

    # ---- outputs: inter (q against carried state) + intra (masked attn)
    qw = qc * torch.exp(cums)[..., None]  # decay from chunk start through step t
    inter = torch.einsum("bnthk,bnhkv->bnthv", qw, S_prev)
    inter_n = torch.einsum("bnthk,bnhk->bnth", qw, n_prev)
    # intra: D[t,s] = exp(cums_t - cums_s) for s <= t
    ld = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B,nc,t,s,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    D = torch.where(causal[None, None, :, :, None], torch.exp(ld), 0.0)
    scores = torch.einsum("bnthk,bnshk->bntsh", qc, kc) * D
    intra = torch.einsum("bntsh,bnshv->bnthv", scores, vc)
    intra_n = torch.sum(scores, dim=3)
    num = inter + intra
    den = torch.clamp(torch.abs(inter_n + intra_n)[..., None], min=1.0)
    out = (num / den).reshape(B, T, H, dh)[:, :T_orig]
    return out, (S, n)


def mlstm_block(params, x, cfg: ModelConfig, *, cache=None):
    """Pre-norm mLSTM block with gated output. x: (B,T,D)."""
    cd = torch_dtype(cfg.compute_dtype)
    B, T, D = x.shape
    h = cfg.n_heads
    xin = rmsnorm(x, params["ln"])
    up = torch.einsum("btd,dm->btm", xin, params["w_up"].to(cd))
    m = up.shape[-1] // 2
    xm, zg = up[..., :m], up[..., m:]
    q = torch.einsum("btm,mhk->bthk", xm, params["wq"].to(cd))
    k = torch.einsum("btm,mhk->bthk", xm, params["wk"].to(cd))
    v = torch.einsum("btm,mhk->bthk", xm, params["wv"].to(cd))
    gates = torch.sigmoid(torch.einsum("btm,mg->btg", xm, params["w_if"].to(cd)).float())
    i_g, f_g = gates[..., :h], gates[..., h:]
    # long-memory bias: keep forget gates near 1
    f_g = 0.9 + 0.1 * f_g
    state = None if cache is None else (cache["C"], cache["n"])
    out, (C_f, n_f) = _mlstm_core(q, k, v, i_g, f_g, cfg.mlstm_chunk, state)
    out = out.reshape(B, T, m).to(cd)
    out = rmsnorm(out, params["out_norm"]) * F.silu(zg)
    y = torch.einsum("btm,md->btd", out, params["w_down"].to(cd))
    new_cache = (
        None
        if cache is None
        else {"C": C_f.to(cache["C"].dtype), "n": n_f.to(cache["n"].dtype)}
    )
    return x + y, new_cache


def mlstm_cache_spec(cfg: ModelConfig, batch: int) -> dict:
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    # the matrix memory is the decode working set (dk x dv per head)
    return {
        "C": ParamSpec((batch, h, dh, dh), ("batch", "heads", None, "ffn"), init="zeros",
                       dtype=cfg.state_dtype),
        "n": ParamSpec((batch, h, dh), ("batch", "heads", None), init="zeros",
                       dtype=cfg.state_dtype),
    }


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — sequential scalar-memory recurrence
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "ln": ParamSpec((d,), (None,), init="ones"),
        "w_gates": ParamSpec((d, 4, h, dh), ("embed", None, "heads", None)),
        "r_gates": ParamSpec((4, h, dh, dh), (None, "heads", None, None), scale=0.5),
        "b_gates": ParamSpec((4, h, dh), (None, "heads", None), init="zeros"),
        "w_down": ParamSpec((d, d), ("embed", "embed")),
    }


def slstm_block(params, x, cfg: ModelConfig, *, cache=None):
    """x: (B,T,D). Stabilized exponential gating (xLSTM eqs. 13-19)."""
    cd = torch_dtype(cfg.compute_dtype)
    B, T, D = x.shape
    h = cfg.n_heads
    dh = D // h
    xin = rmsnorm(x, params["ln"])
    # input contributions for all steps upfront (B,T,4,H,dh)
    zx = torch.einsum("btd,dghk->btghk", xin, params["w_gates"].to(cd)).float()
    r_w = params["r_gates"].float()
    b = params["b_gates"].float()

    if cache is None:
        c = torch.zeros((B, h, dh), dtype=torch.float32, device=x.device)
        n = torch.ones_like(c)
        m = torch.zeros_like(c)
        hp = torch.zeros_like(c)
    else:
        c, n, m, hp = (cache[key].float() for key in ("c", "n", "m", "h"))

    hs = []
    for t in range(T):
        g = zx[:, t] + torch.einsum("bhk,ghks->bghs", hp, r_w) + b  # (B,4,H,dh)
        zt, it, ft, ot = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * torch.tanh(zt)
        n = f_p * n + i_p
        hp = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hp)
    hs = torch.stack(hs, dim=1).reshape(B, T, D).to(cd)
    y = torch.einsum("btd,de->bte", hs, params["w_down"].to(cd))
    new_cache = None if cache is None else {"c": c, "n": n, "m": m, "h": hp}
    return x + y, new_cache


def slstm_cache_spec(cfg: ModelConfig, batch: int) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h
    s = ParamSpec((batch, h, dh), ("batch", "heads", None), init="zeros", dtype="float32")
    return {"c": s, "n": ParamSpec((batch, h, dh), ("batch", "heads", None), init="ones",
                                   dtype="float32"), "m": s, "h": s}
