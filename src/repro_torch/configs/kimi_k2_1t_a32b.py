"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified, paper-table]: 61L d=7168
64H (GQA kv=8, head_dim 128) vocab=163840, MoE 384 routed experts
(d_ff_expert=2048) top-8 + 1 shared; dense first layer. Trillion-parameter
class: bf16 params + bf16 optimizer state (DESIGN.md memory notes)."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,  # dense first layer
    d_ff_expert=2048,  # assignment-table d_ff: expert width
    vocab_size=163_840,
    first_blocks=("attn",),
    pattern=("moe",),
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    rope_theta=50_000.0,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
)

REDUCED = reduced(CONFIG)
