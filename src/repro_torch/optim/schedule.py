"""LR schedules — the port of the JAX package's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac · base_lr`` at ``total`` → a 0-d float32 tensor on
    the CPU. Every operation is float32, as the reference's ``jnp.float32``
    arithmetic, so the rate is the reference's to the last bit or one ulp."""
    f32 = dict(dtype=torch.float32)
    step = torch.as_tensor(step).to(**f32)
    warm = base_lr * step / max(1.0, float(warmup))
    t = torch.clamp((step - warmup) / max(1.0, float(total - warmup)), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(torch.tensor(math.pi, **f32) * t)))
    return torch.where(step < warmup, warm, cos)
