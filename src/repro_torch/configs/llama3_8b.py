"""llama3-8b [arXiv:2407.21783]: 32L d=4096 32H GQA kv=8 d_ff=14336
vocab=128256, rope theta 500k."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
)

REDUCED = reduced(CONFIG)
