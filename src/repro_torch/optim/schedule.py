"""Learning-rate schedules (pure functions of the step counter) — a copy of
``repro/optim/schedule.py``: each returns an fp32 tensor on the CPU, or
on the device of a tensor ``step``."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device if isinstance(step, torch.Tensor) else None)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, *, final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = peak_lr * s / max(1, warmup_steps)
        progress = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        s = _step(step)
        warm = peak_lr * s / max(1, warmup_steps)
        decay = peak_lr * torch.clamp(
            1.0 - (s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0
        )
        return torch.where(s < warmup_steps, warm, decay)

    return fn
