"""musicgen-large [arXiv:2306.05284; hf]: decoder-only backbone over EnCodec
tokens — 48L d=2048 32H MHA d_ff=8192 (plain GELU FFN) vocab=2048.
Modality frontend is a STUB: training consumes precomputed frame embeddings
(input_specs provides (B, S, d_model) floats); decode embeds the 2048-way
code tokens directly."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_kind="gelu",
    train_input="embeds",
    param_dtype="bfloat16",
)

REDUCED = reduced(CONFIG, train_input="embeds")
