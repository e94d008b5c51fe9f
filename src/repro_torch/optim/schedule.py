"""LR schedules as step → multiplier functions (composable with
``AdamWConfig.schedule`` and ``AdafactorConfig.schedule``).

Port of ``src/repro/optim/schedule.py``. The optimizers keep their step
count as a Python int, so each schedule is a function of an int step that
returns a float.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def linear_warmup_cosine(warmup: int, total: int,
                         floor: float = 0.1) -> Schedule:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at step ``total``, held there after it."""
    def f(step: int) -> float:
        warm = min(1.0, step / max(1, warmup))
        t = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))
    return f


def constant() -> Schedule:
    return lambda step: 1.0


def rsqrt(warmup: int) -> Schedule:
    """``min(step / warmup^1.5, 1/sqrt(step))``: the reference's inverse
    square root with its warm-up."""
    def f(step: int) -> float:
        return min(step / max(1, warmup) ** 1.5,
                   1.0 / math.sqrt(max(step, 1.0)))
    return f
