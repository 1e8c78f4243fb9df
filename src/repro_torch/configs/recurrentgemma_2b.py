"""recurrentgemma-2b [arXiv:2402.19427; hf]: 26L d=2560 10H MQA (kv=1),
d_ff=7680 (GeGLU), vocab=256000, RG-LRU width 2560, conv1d k=4, local
attention window 2048, layout (rec, rec, local) x8 + (rec, rec) tail.
Sub-quadratic: runs long_500k."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rec", "rec", "local"),
    window=2048,
    rnn_width=2560,
    conv1d_size=4,
    mlp_kind="geglu",
    tie_embeddings=True,
)

REDUCED = reduced(CONFIG, n_layers=3, window=64)
