"""LR schedules as pure functions of the step (port of the JAX package's
schedulers/__init__.py).

`schedule(t)` is the learning rate of optimizer step t, counted from 0, as
optax counts; the model sets it on the torch optimizer before each step.
`warmup_iter` linear warmup composes multiplicatively (`with_warmup`).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import numpy as np

Schedule = Callable[[int], float]


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def constant_lr(base_lr: float, factor: float = 1.0 / 3, total_iters: int = 5) -> Schedule:
    return lambda step: base_lr * factor if step < total_iters else base_lr


def linear_lr(base_lr: float, start_factor: float = 1.0 / 3, end_factor: float = 1.0,
              total_iters: int = 5) -> Schedule:
    def sched(step):
        t = _clip01(step / total_iters)
        return base_lr * (start_factor + (end_factor - start_factor) * t)

    return sched


def exponential_lr(base_lr: float, gamma: float) -> Schedule:
    return lambda step: base_lr * gamma**step


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    return lambda step: base_lr * gamma ** math.floor(step / step_size)


def multi_step_lr(base_lr: float, milestones: list[int], gamma: float = 0.5) -> Schedule:
    ms = sorted(milestones)
    return lambda step: base_lr * gamma ** sum(step >= m for m in ms)


def polynomial_lr(base_lr: float, total_iters: int = 5, power: float = 1.0) -> Schedule:
    return lambda step: base_lr * (1.0 - _clip01(step / total_iters)) ** power


def cosine_annealing_lr(base_lr: float, T_max: int, eta_min: float = 0.0) -> Schedule:
    def sched(step):
        t = _clip01(step / T_max)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


def cosine_annealing_warm_restarts(base_lr: float, T_0: int, T_mult: int = 1,
                                   eta_min: float = 0.0) -> Schedule:
    if T_mult == 1:
        def sched(step):
            t = (step % T_0) / T_0
            return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))

        return sched

    def sched(step):  # geometric cycles: closed form for the cycle index
        n = math.floor(math.log(step / T_0 * (T_mult - 1) + 1) / math.log(T_mult))
        cycle_start = T_0 * (float(T_mult) ** n - 1) / (T_mult - 1)
        t = (step - cycle_start) / (T_0 * float(T_mult) ** n)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


def cosine_annealing_restart_lr(base_lr: float, periods: list[int],
                                restart_weights: list[float] | None = None,
                                eta_min: float = 0.0) -> Schedule:
    """Per-period restart weights scaling the peak LR of each cosine segment."""
    restart_weights = restart_weights or [1.0] * len(periods)
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights differ in length")
    ends = np.cumsum(periods)
    starts = ends - np.asarray(periods)

    def sched(step):
        step = min(float(step), float(ends[-1]) - 1.0)
        idx = min(int(np.sum(step >= ends)), len(periods) - 1)
        t = _clip01((step - starts[idx]) / periods[idx])
        return eta_min + restart_weights[idx] * (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t))

    return sched


def knee_lr(base_lr: float, peak_lr: float, total_steps: int, explore_ratio: float = 0.5,
            warmup_steps: int = 0) -> Schedule:
    """Explore-then-decay: hold peak_lr for the explore phase, then decay
    linearly to 0."""
    explore_steps = int(total_steps * explore_ratio)

    def sched(step):
        warm = _clip01(step / max(warmup_steps, 1)) if warmup_steps > 0 else 1.0
        decay_t = _clip01((step - explore_steps) / max(total_steps - explore_steps, 1))
        return peak_lr * warm * (1.0 - decay_t)

    return sched


def one_cycle_lr(base_lr: float, max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = int(total_steps * pct_start)

    def sched(step):
        if step < up_steps:
            up_t = _clip01(step / max(up_steps, 1))
            return initial_lr + (max_lr - initial_lr) * 0.5 * (1 - math.cos(math.pi * up_t))
        down_t = _clip01((step - up_steps) / max(total_steps - up_steps, 1))
        return min_lr + (max_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * down_t))

    return sched


def build_scheduler(scheduler_opt: dict[str, Any] | None, base_lr: float,
                    total_iter: int) -> Schedule:
    """Resolve a scheduler config into a step -> lr function. None = constant."""
    if scheduler_opt is None:
        return lambda step: base_lr
    opt = dict(scheduler_opt)
    stype = str(opt.pop("type")).upper()
    table: dict[str, Callable[..., Schedule]] = {
        "CONSTANTLR": constant_lr,
        "LINEARLR": linear_lr,
        "EXPONENTIALLR": exponential_lr,
        "STEPLR": step_lr,
        "MULTISTEPLR": multi_step_lr,
        "POLYNOMIALLR": polynomial_lr,
        "COSINEANNEALINGLR": cosine_annealing_lr,
        "COSINEANNEALINGWARMRESTARTS": cosine_annealing_warm_restarts,
        "COSINEANNEALINGRESTARTLR": cosine_annealing_restart_lr,
        "ONECYCLELR": one_cycle_lr,
        "KNEELR": lambda base_lr, **kw: knee_lr(
            base_lr, kw.pop("peak_lr", base_lr), kw.pop("total_steps", total_iter), **kw
        ),
    }
    if stype not in table:
        raise NotImplementedError(f"Scheduler {stype} is not implemented yet.")
    return table[stype](base_lr, **opt)


def with_warmup(schedule: Schedule, warmup_iter: int | None) -> Schedule:
    """Linear LR warmup over the first `warmup_iter` steps; <= 0 disables."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule
    return lambda step: schedule(step) * _clip01((step + 1.0) / warmup_iter)
