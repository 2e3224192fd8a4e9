"""Learning-rate schedules: the counterpart of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, peak_lr: float, warmup: int, total: int, floor: float = 0.0) -> float:
    """Linear warmup then cosine decay to ``floor``, in float32 in the
    reference's order of operations; returns a Python float."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    step = f32(float(step))
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak_lr - floor) * (1.0 + torch.cos(f32(math.pi) * frac))
    return float(torch.where(step < warmup, warm, cos))
