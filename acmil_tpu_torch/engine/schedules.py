"""Schedules, the port of ``acmil_tpu/engine/schedules.py``:
``half_cosine_schedule`` (the learning rate), ``step_schedule`` (step
decay) and ``cosine_array`` (MHIM's EMA momentum and mask ratio)."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


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


def step_schedule(lr: float, total_epochs: int, steps_per_epoch: int,
                  milestones=(0.5, 0.75),
                  gamma: float = 0.1) -> Callable[[int], float]:
    """Step decay at fractional milestones (`utils/utils.py:264-270`): the
    rate times ``gamma`` for each milestone ``m`` with ``epoch >= m *
    total_epochs``, the epoch fractional per step."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        factor = 1.0
        for m in milestones:
            if epoch >= m * total_epochs:
                factor *= gamma
        return lr * factor

    return schedule


def cosine_array(base: float, final: float, epochs: int, steps_per_epoch: int,
                 warmup_epochs: int = 0, start_warmup: float = 0.0) -> np.ndarray:
    """The per-step cosine array of the reference's ``cosine_scheduler``
    (`utils/utils.py:529-540`), float64: a linear warmup from
    ``start_warmup``, then a cosine from ``base`` to ``final``."""
    warmup_iters = warmup_epochs * steps_per_epoch
    warmup = (np.linspace(start_warmup, base, warmup_iters) if warmup_iters
              else np.array([]))
    iters = np.arange(epochs * steps_per_epoch - warmup_iters)
    denom = max(len(iters), 1)
    sched = final + 0.5 * (base - final) * (1 + np.cos(np.pi * iters / denom))
    return np.concatenate([warmup, sched])
