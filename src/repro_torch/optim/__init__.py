"""Optimizer-side utilities of the port. Only ``magnitude_prune`` (the
sparse-serving path) is here so far; AdamW, the schedules and gradient
compression wait for the training slice."""

from repro_torch.optim.compress import magnitude_prune

__all__ = ["magnitude_prune"]
