"""Learning-rate schedules (the reference's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to 1.0, cosine decay to ``floor`` at ``total``: a
    float32 0-d tensor on the step's device (the CPU for an int)."""
    s = step.to(torch.float32) if isinstance(step, torch.Tensor) \
        else torch.tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
