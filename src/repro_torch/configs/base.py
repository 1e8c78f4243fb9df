"""Architecture + workload-shape configuration system.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published configuration) and ``REDUCED`` (a
same-family shrink used by CPU smoke tests). Pure Python, carried over
from the reference package unchanged. Workload shapes (the assigned
input-shape set) live in ``shapes.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    # trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # block layout: optional non-repeating prefix + repeating pattern unit.
    # block kinds: "attn" (global attn + mlp), "local" (windowed attn + mlp),
    # "moe" (attn + mixture FFN), "mlstm", "slstm", "rec" (RG-LRU block)
    pattern: tuple[str, ...] = ("attn",)
    first_blocks: tuple[str, ...] = ()
    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0  # local-attention window (block-local, DESIGN.md)
    attn_chunk: int = 512  # flash-chunk length (KV axis)
    prefix_lm: bool = False  # bidirectional attention over the prefix
    # FFN nonlinearity: swiglu (llama), geglu (gemma), gelu (2-matrix, musicgen)
    mlp_kind: str = "swiglu"
    # training input modality: "tokens" or "embeds" (stub frontends feed
    # precomputed frame/patch embeddings)
    train_input: str = "tokens"
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    dispatch_format: str = "ell"  # ell | sell | dense — the Auto-SpMV knob
    # recurrent families
    rnn_width: int = 0  # RG-LRU state width (0 -> d_model)
    conv1d_size: int = 4
    mlstm_chunk: int = 64  # chunkwise-parallel mLSTM chunk length
    # modality frontend stubs ([audio]/[vlm] backbones; DESIGN.md §5)
    prefix_len: int = 0  # stub prefix tokens (SigLIP patches / EnCodec frames)
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # recurrent/KV decode-state precision; bf16 halves the per-token state
    # traffic of state-bound decoders (xlstm) at a documented accuracy cost
    state_dtype: str = "float32"
    remat: bool = True
    logits_softcap: float = 0.0
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        n_rep = self.n_layers - len(self.first_blocks)
        if n_rep < 0:
            raise ValueError("first_blocks longer than n_layers")

    # ---- block layout helpers ------------------------------------------
    @property
    def n_pattern_layers(self) -> int:
        return self.n_layers - len(self.first_blocks)

    @property
    def n_groups(self) -> int:
        """Number of scanned repetitions of the full pattern unit."""
        return self.n_pattern_layers // len(self.pattern)

    @property
    def tail_blocks(self) -> tuple[str, ...]:
        r = self.n_pattern_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def block_kinds(self) -> tuple[str, ...]:
        return tuple(sorted(set(self.first_blocks) | set(self.pattern)))

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (roofline MODEL_FLOPS) ----------------------
    def param_counts(self) -> dict[str, float]:
        """Approximate parameter counts: total and active-per-token."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        ffn_mats = 2 if self.mlp_kind == "gelu" else 3  # gated variants add one
        mlp = ffn_mats * d * self.d_ff
        moe_expert = 3 * d * self.d_ff_expert
        shared = self.n_shared_experts * moe_expert
        router = d * self.n_experts
        rec_w = self.rnn_dim
        rec = 2 * d * rec_w + rec_w * d + self.conv1d_size * rec_w + 2 * rec_w
        mlstm = 2 * d * 2 * d + 3 * (2 * d) * (2 * d) // 1  # up/down + qkv on 2d
        slstm = 4 * d * d
        per_block_total = {
            "attn": attn + mlp,
            "local": attn + mlp,
            "moe": attn + router + shared + self.n_experts * moe_expert,
            "rec": rec + mlp,
            "mlstm": mlstm,
            "slstm": slstm,
        }
        per_block_active = dict(per_block_total)
        per_block_active["moe"] = attn + router + shared + self.top_k * moe_expert
        blocks = list(self.first_blocks) + list(self.pattern) * self.n_groups + list(
            self.tail_blocks
        )
        total = sum(per_block_total[b] for b in blocks)
        active = sum(per_block_active[b] for b in blocks)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return {
            "total": float(total + embed),
            "active": float(active + embed),
            "embed": float(embed),
        }


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family shrink for CPU smoke tests: small width/depth, few
    experts, tiny vocab — structure preserved."""
    pat = len(cfg.pattern)
    kw = dict(
        n_layers=len(cfg.first_blocks) + max(pat, 2 if pat == 1 else pat),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_chunk=64,
        window=min(cfg.window, 64) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        rnn_width=64 if cfg.rnn_width else 0,
        mlstm_chunk=16,
        prefix_len=min(cfg.prefix_len, 8) if cfg.prefix_len else 0,
        param_dtype="float32",
        compute_dtype="float32",
        opt_state_dtype="float32",
        name=cfg.name + "-reduced",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
