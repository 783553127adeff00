"""Seeding (`utils/utils.py:226-243`), the port of
``acmil_tpu/utils/seed.py``: the host's RNGs and torch's (every device)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
