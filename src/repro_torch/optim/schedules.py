"""LR schedules (plain callables: step -> lr), computed in fp32 as the
reference's ``src/repro/optim/schedules.py`` computes them.  ``step`` may be
an int or a tensor (the train state's step, on the card); the rate is an
fp32 tensor on the step's device."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_warmup(base_lr: float, warmup_steps: int):
    def lr(step):
        s = _f32(step)
        return base_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return lr


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 \
            * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos
    return lr
