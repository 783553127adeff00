"""The learning-rate schedule of the training slice, the port of
``acmil_tpu/engine/schedules.py::half_cosine_schedule``."""

from __future__ import annotations

import math
from typing import Callable


def half_cosine_schedule(lr: float, min_lr: float, total_epochs: int,
                         warmup_epochs: int,
                         steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's ``adjust_learning_rate`` (`utils/utils.py:250-262`)
    as a function of the optimizer step counted from 0: linear warmup, then
    half-cosine decay to ``min_lr``; the epoch is fractional per step."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return lr * epoch / warmup_epochs
        denom = max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule
