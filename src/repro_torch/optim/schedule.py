"""Learning-rate schedules (``repro/optim/schedule.py``), in f32 from the
step as the JAX code computes them."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step).float()
        t = torch.clamp(s, max=float(total_steps)) / total_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(
    base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(step - warmup))
    return lr
