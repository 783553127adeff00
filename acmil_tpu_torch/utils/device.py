"""The device an entry point runs on.

Entry points run on the card unless the caller names another device: with
no ``--device`` they take ``cuda``, and on a machine without a usable CUDA
device they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def entry_device(name: Optional[str] = None) -> torch.device:
    """``torch.device(name)``, ``cuda`` when ``name`` is empty; raises
    RuntimeError if that is a CUDA device and none is available."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port's entry points run on "
            "the card; pass --device cpu to run on the CPU")
    return device
