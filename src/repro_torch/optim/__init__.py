"""Optimizer-side code of the port: AdamW with global-norm clipping and
low-precision moments, learning-rate schedules, top-k gradient compression
with error feedback, and magnitude pruning for the sparse-serving path."""

from repro_torch.optim.adamw import AdamWConfig, apply_adamw, init_opt_state
from repro_torch.optim.compress import compress_gradients, init_error_feedback, magnitude_prune
from repro_torch.optim.schedule import constant, cosine_schedule, linear_warmup

__all__ = [
    "AdamWConfig",
    "apply_adamw",
    "init_opt_state",
    "constant",
    "cosine_schedule",
    "linear_warmup",
    "compress_gradients",
    "init_error_feedback",
    "magnitude_prune",
]
