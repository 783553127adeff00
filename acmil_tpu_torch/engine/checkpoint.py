"""Checkpoints in the reference's ``.pth`` format.

The reference saves ``checkpoint-{best,last}.pth`` as ``{'model':
state_dict, 'optimizer': ..., 'epoch': ..., 'config': Struct}``
(`utils/utils.py:415-422`). The port writes the same dict with the config
as a plain dict, and reads both its own files and the reference's with
``torch.load(weights_only=True)``: the reference's pickled
``utils.utils.Struct`` config is admitted as a known class and read back as
a dict. Parameter names are the reference's, so a reference-trained
checkpoint loads with no conversion.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

# the arch hyperparams a checkpoint's weights were trained with — consumers
# (predict) must rebuild the model with these
MODEL_CONFIG_KEYS = ("arch", "n_token", "n_masked_patch", "mask_drop",
                     "D_feat", "D_inner", "n_class")


class Struct:
    """Unpickle stand-in for the reference's ``utils.utils.Struct``
    (`utils/utils.py:246`), which reference checkpoints pickle their
    config as."""

    def __init__(self, **entries):
        self.__dict__.update(entries)


Struct.__module__ = "utils.utils"


def checkpoint_path(ckpt: str, tag: str = "best") -> str:
    """``ckpt`` itself when it is a file, else ``ckpt/checkpoint-{tag}.pth``."""
    return ckpt if os.path.isfile(ckpt) else os.path.join(
        ckpt, f"checkpoint-{tag}.pth")


def save(path: str, model, epoch: int = -1, conf=None) -> None:
    """Write ``model``'s weights in the reference's format (the optimizer
    state stays empty until the training slice)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "model": model.state_dict(),
        "optimizer": {},
        "epoch": int(epoch),
        "config": conf.to_dict() if conf is not None else {},
    }, path)


def load(path: str) -> Dict[str, Any]:
    """The checkpoint dict on the CPU, its ``config`` as a plain dict."""
    with torch.serialization.safe_globals([Struct]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(f"{path} is not a save_model checkpoint (expected "
                         "a dict with a 'model' state_dict)")
    cfg = ckpt.get("config")
    ckpt["config"] = dict(vars(cfg) if isinstance(cfg, Struct) else cfg or {})
    return ckpt


def adopt_checkpoint_config(conf, saved: Dict[str, Any]) -> None:
    """Copy the saved model-shape keys (``MODEL_CONFIG_KEYS``) onto
    ``conf``: weights only load into the model shape that trained them."""
    for k in MODEL_CONFIG_KEYS:
        if k in saved:
            setattr(conf, k, saved[k])
