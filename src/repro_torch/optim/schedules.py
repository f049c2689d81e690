"""Learning-rate schedules as step -> lr callables: the port of
``repro/optim/schedules.py``.  A step is an integer tensor (or a Python
int); the rate is a float32 0-dim tensor on the step's device, computed in
float32 as the reference computes it, so a step on the card reads nothing
back to the host."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        s = _f32(step)
        warm = lr * s / max(1, warmup)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return fn
