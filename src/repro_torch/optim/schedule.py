"""Learning-rate schedules of a Python int step (counterpart of
``repro.optim.schedule``)."""

from __future__ import annotations

import math


def linear_warmup(step: int, warmup_steps: int, peak: float) -> float:
    """``peak · min(1, (step + 1) / warmup_steps)``."""
    return peak * min(1.0, (step + 1) / max(1, warmup_steps))


def cosine_schedule(step: int, warmup_steps: int, total_steps: int,
                    peak: float, floor_frac: float = 0.1) -> float:
    """Linear warmup, then a cosine from ``peak`` down to ``floor_frac ·
    peak`` at ``total_steps``."""
    if step < warmup_steps:
        return linear_warmup(step, warmup_steps, peak)
    frac = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps),
                   0.0), 1.0)
    return peak * (floor_frac + (1 - floor_frac) * 0.5
                   * (1 + math.cos(math.pi * frac)))
