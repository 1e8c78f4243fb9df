"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L d=2048 16H (kv=16) vocab=102400,
fine-grained MoE: 64 routed experts (d_ff_expert=1408) top-6 + 2 shared;
layer 0 is a dense FFN (intermediate 10944, HF config)."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense first layer (HF intermediate_size)
    d_ff_expert=1408,  # assignment-table d_ff: the fine-grained expert width
    vocab_size=102_400,
    first_blocks=("attn",),
    pattern=("moe",),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
)

REDUCED = reduced(CONFIG)
