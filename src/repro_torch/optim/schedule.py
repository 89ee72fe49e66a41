"""LR schedules (warmup + cosine decay), pure functions of the step,
computed in fp32 as the reference's are.  ``step`` may be an int or a 0-d
tensor (the optimizer's step counter); the result is a 0-d fp32 tensor on
the step's device."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * cos


def constant(step) -> torch.Tensor:
    return torch.ones_like(_f32(step))
