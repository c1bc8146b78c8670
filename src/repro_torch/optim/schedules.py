"""LR schedules: linear warmup + cosine decay (the usual production shape)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), as a 0-d
    float32 tensor on the step's device: linear from 0 to ``peak_lr`` over
    ``warmup_steps``, then a cosine down to ``min_ratio * peak_lr`` at
    ``total_steps``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)
            ).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
