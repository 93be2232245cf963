"""Learning-rate schedules (port of dynavsr_tpu/train/schedules.py): plain
functions of the update count that return the lr as a float.

CosineAnnealingLR_Restart: concatenated cosine periods, each starting at
base_lr times its restart weight and ending at eta_min. MultiStepLR_Restart:
gamma decay at milestones, with optional restarts that reset the decay and
rescale by their weight. The JAX package's conventions are kept: a
`restart_weights` one shorter than `periods` gets a 1 prepended (the
reference pairs weights with restarts), the count is clamped at the last
period's last update, the period of a count is the first whose end lies
beyond it, and warmup scales by (count + 1) / warmup_iter. The JAX package
evaluates them in float32; these evaluate in float64.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

__all__ = ["cosine_annealing_restart", "multistep_restart", "with_warmup"]

Schedule = Callable[[int], float]


def cosine_annealing_restart(base_lr: float, periods: Sequence[int],
                             restart_weights: Sequence[float] = None,
                             eta_min: float = 1e-7) -> Schedule:
    periods = list(periods)
    weights = list(restart_weights or [1.0] * len(periods))
    if len(weights) == len(periods) - 1:
        weights = [1.0] + weights
    if len(weights) != len(periods):
        raise ValueError("restart_weights must match periods")
    bounds, starts, acc = [], [], 0
    for p in periods:
        starts.append(acc)
        acc += p
        bounds.append(acc)

    def schedule(count: int) -> float:
        c = min(float(count), bounds[-1] - 1.0)
        idx = min(bisect.bisect_right(bounds, c), len(periods) - 1)
        t = (c - starts[idx]) / periods[idx]
        max_lr = base_lr * weights[idx]
        return eta_min + 0.5 * (max_lr - eta_min) * (1.0 + math.cos(math.pi * t))

    return schedule


def multistep_restart(base_lr: float, milestones: Sequence[int], gamma: float = 0.5,
                      restarts: Sequence[int] = (),
                      restart_weights: Sequence[float] = ()) -> Schedule:
    """lr = base_lr * w_restart * gamma^(milestones passed since the last
    restart)."""
    milestones = sorted(milestones)
    restarts = sorted(restarts)
    weights = list(restart_weights) or [1.0] * len(restarts)
    if restarts and len(weights) != len(restarts):
        raise ValueError("restart_weights must match restarts")
    rw = [1.0] + weights
    # milestones passed at or before each restart (what the restart resets)
    pre = [0] + [sum(1 for m in milestones if m <= r) for r in restarts]

    def schedule(count: int) -> float:
        n_ms = bisect.bisect_right(milestones, count)
        r_idx = bisect.bisect_right(restarts, count)
        return base_lr * rw[r_idx] * gamma ** max(n_ms - pre[r_idx], 0)

    return schedule


def with_warmup(schedule: Schedule, warmup_iter: int) -> Schedule:
    """Linear warmup: schedule(count) * (count + 1) / warmup_iter for the
    first warmup_iter counts."""
    if warmup_iter <= 0:
        return schedule

    def warmed(count: int) -> float:
        target = schedule(count)
        if count < warmup_iter:
            return target * min(max((count + 1.0) / warmup_iter, 0.0), 1.0)
        return target

    return warmed
