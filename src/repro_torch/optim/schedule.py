"""Learning-rate schedules as step → lr callables (port of ``repro/optim/schedule.py``).

Each returns a float32 0-d tensor on the CPU, computed in float32 as the
reference computes it (a Python step is divided in float64 and rounded to
float32 once, as ``jnp.clip`` rounds it there).
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "warmup_cosine"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr):
    return lambda step: _f32(lr)


def cosine_decay(lr, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(_f32(step / total_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return _f32(lr * (final_frac + (1 - final_frac) * cos))
    return f


def warmup_cosine(lr, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        w = torch.clamp(_f32(step / max(warmup_steps, 1)), 0.0, 1.0)
        return torch.where(torch.as_tensor(step) < warmup_steps, _f32(lr) * w,
                           decay(step - warmup_steps))
    return f
