"""xlstm-1.3b [arXiv:2405.04517]: 48 blocks d=2048, 4 heads, no separate FFN
(d_ff=0); xLSTM[7:1] layout — pattern unit of 7 mLSTM + 1 sLSTM blocks,
6 scanned groups. Sub-quadratic: runs long_500k."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_chunk=64,
)

REDUCED = reduced(CONFIG, pattern=("mlstm", "slstm"), n_layers=2)
