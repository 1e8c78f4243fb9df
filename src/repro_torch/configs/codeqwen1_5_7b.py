"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d=4096 32H MHA (kv=32)
d_ff=13440 vocab=92416."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92_416,
    rope_theta=1_000_000.0,  # CodeQwen 64k context
    param_dtype="bfloat16",
)

REDUCED = reduced(CONFIG)
