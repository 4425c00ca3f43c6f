"""Learning-rate schedules. Counterpart: `map_tpu/train/schedules.py`
(transformers' constant and cosine schedules with warmup).

A schedule maps the optimizer's step count (the count BEFORE this step's
increment, `map_tpu/train/optimizer.py:121`) to the learning rate, computed
in float32 on the host as map_tpu computes it on the device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def constant_with_warmup(base_lr: float, num_warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        step = _F(step)
        warm = step / max(_F(1.0), _F(num_warmup_steps))
        return float(_F(base_lr) * (warm if step < num_warmup_steps else _F(1.0)))

    return schedule


def cosine_with_warmup(base_lr: float, num_warmup_steps: int,
                       num_training_steps: int, num_cycles: float = 0.5) -> Schedule:
    def schedule(step: int) -> float:
        step = _F(step)
        if step < num_warmup_steps:
            factor = step / max(_F(1.0), _F(num_warmup_steps))
        else:
            progress = (step - _F(num_warmup_steps)) / max(
                _F(1.0), _F(num_training_steps - num_warmup_steps))
            cos = _F(0.5) * (_F(1.0) + np.cos(_F(math.pi * num_cycles * 2.0) * progress))
            factor = max(_F(0.0), cos)
        return float(_F(base_lr) * factor)

    return schedule


def make_schedule(lr_sched: str, base_lr: float, num_warmup_steps: int,
                  num_training_steps: int) -> Schedule:
    s = lr_sched.lower()
    if s == "cosine":
        return cosine_with_warmup(base_lr, num_warmup_steps, num_training_steps)
    if s == "const":
        return constant_with_warmup(base_lr, num_warmup_steps)
    raise NotImplementedError(lr_sched)
