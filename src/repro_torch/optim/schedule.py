"""Learning-rate schedules (pure functions of the step counter).

Each takes the optimizer's 0-d integer step tensor and returns a 0-d
float32 tensor on the same device, in the reference's float32 arithmetic,
so that reading the rate never waits for the device."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = step.to(torch.float32)
        return lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return f


def cosine_schedule(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return f
