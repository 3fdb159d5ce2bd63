"""Learning-rate schedules with diffusers ``get_scheduler`` semantics.

Counterpart of edgestyle_tpu/training/schedules.py, as host functions from
step to float: the trainer's step counter is a host int, so reading the
rate never waits on the device.

Names: constant, constant_with_warmup, linear, cosine,
cosine_with_restarts, polynomial; ``cosine_annealing`` is an alias of
``cosine``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

NAMES = ("constant", "constant_with_warmup", "linear", "cosine",
         "cosine_with_restarts", "polynomial", "cosine_annealing")


def build_lr_schedule(name: str, learning_rate: float, warmup_steps: int = 0,
                      total_steps: Optional[int] = None, num_cycles: float = 1.0,
                      power: float = 1.0, lr_end: float = 1e-7) -> Callable[[int], float]:
    """step -> lr. Warmup is linear 0 -> lr over ``warmup_steps`` for every
    schedule but plain ``constant``; cosine runs the half-wave (diffusers
    forwards num_cycles only to cosine_with_restarts and power only to
    polynomial)."""
    if name == "cosine_annealing":
        name = "cosine"
    if name not in NAMES:
        raise ValueError(f"unknown lr_scheduler {name!r}; known: {NAMES}")
    if name not in ("constant", "constant_with_warmup") and not total_steps:
        raise ValueError(f"lr_scheduler={name!r} needs total_steps")
    lr = float(learning_rate)
    w = max(int(warmup_steps), 0)

    def sched(step: int) -> float:
        s = float(step)
        warm = s / max(w, 1)
        if name == "constant":
            return lr
        if name == "constant_with_warmup":
            return lr * (min(1.0, warm) if w else 1.0)
        if w and s < w:
            return lr * warm
        progress = (s - w) / max(int(total_steps) - w, 1)
        if name == "linear":
            mult = max(0.0, 1.0 - progress)
        elif name == "cosine":
            mult = max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
        elif name == "cosine_with_restarts":
            frac = (float(num_cycles) * progress) % 1.0
            mult = 0.0 if progress >= 1.0 else max(0.0, 0.5 * (1.0 + math.cos(math.pi * frac)))
        else:  # polynomial: lr -> lr_end, as a multiplier of lr
            if s > float(total_steps):
                mult = lr_end / lr
            else:
                pct = min(max(1.0 - progress, 0.0), 1.0)
                mult = ((lr - lr_end) * pct ** float(power) + lr_end) / lr
        return lr * mult

    return sched
