"""LR schedules: functions of a 0-d step tensor, returning a 0-d float32
tensor on the step's device (twin of :mod:`repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup: int, total: int,
                       floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor × peak``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, peak_lr * cos)
    return lr


def constant(lr_value: float):
    def lr(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr_value, dtype=torch.float32,
                          device=step.device)
    return lr
