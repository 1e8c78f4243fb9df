"""paligemma-3b [arXiv:2407.07726; hf]: Gemma-2B text backbone — 18L d=2048
8H MQA (kv=1, head_dim 256) d_ff=16384 GeGLU vocab=257216 — behind a SigLIP
stub: input_specs provides 256 precomputed patch embeddings as a prefix with
bidirectional (prefix-LM) attention."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    mlp_kind="geglu",
    prefix_len=256,
    prefix_lm=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
)

REDUCED = reduced(CONFIG, prefix_len=8, prefix_lm=True)
