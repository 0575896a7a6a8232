"""Learning-rate schedules (paper App. C; port of repro/core/schedules.py).
A schedule maps the step count to an f32 scalar tensor."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    def sched(count):
        return torch.tensor(value, dtype=torch.float32)

    return sched


def warmup_cosine(peak: float, total_steps: int, warmup_frac: float = 0.05,
                  end_value: float = 0.0):
    """Linear warmup for ``warmup_frac`` of training, then cosine decay."""
    warmup_steps = max(int(total_steps * warmup_frac), 1)

    def sched(count):
        count = torch.tensor(count, dtype=torch.float32)
        warm = peak * count / warmup_steps
        decay_steps = max(total_steps - warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps) / decay_steps, 0.0, 1.0)
        cos = end_value + (peak - end_value) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(count < warmup_steps, warm, cos)

    return sched
