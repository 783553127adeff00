"""Checkpoints in the reference's ``.pth`` format.

The reference saves ``checkpoint-{best,last}.pth`` as ``{'model':
state_dict, 'optimizer': ..., 'epoch': ..., 'config': Struct}``
(`utils/utils.py:415-422`). The port writes the same dict with the config
as a plain dict, plus the step count, the val metrics the checkpoint was
chosen by, the state of the generator STKIM draws from and, for MHIM, the
EMA teacher's weights under ``teacher``, and reads both its own files and
the reference's with ``torch.load(weights_only=True)``: the reference's pickled
``utils.utils.Struct`` config is admitted as a known class and read back as
a dict. Parameter names are the reference's, so a reference-trained
checkpoint loads with no conversion.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import torch

# the arch hyperparams a checkpoint's weights were trained with — consumers
# (predict) must rebuild the model with these; CLAM's droprate places its
# attention net (``attention_net.2`` or ``.3``)
MODEL_CONFIG_KEYS = ("arch", "n_token", "n_masked_patch", "mask_drop",
                     "D_feat", "D_inner", "n_class", "droprate")


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


def save(path: str, model, epoch: int = -1, conf=None, optimizer=None,
         metrics: Optional[Dict[str, float]] = None, step: int = 0,
         generator: Optional[torch.Generator] = None,
         teacher: Optional[torch.nn.Module] = None) -> None:
    """Write ``model``'s weights, ``optimizer``'s state (empty when None),
    the epoch, the config, ``metrics``, the optimizer ``step``,
    ``generator``'s state and ``teacher``'s weights (each when given) in the
    reference's format. The file
    is written whole and then renamed, so a crash leaves the previous
    checkpoint in place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    obj = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else {},
        "epoch": int(epoch),
        "config": conf.to_dict() if conf is not None else {},
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        "step": int(step),
    }
    if generator is not None:
        obj["generator"] = generator.get_state()
    if teacher is not None:
        obj["teacher"] = teacher.state_dict()
    torch.save(obj, tmp)
    os.replace(tmp, path)


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


def adopt_checkpoint_config(conf, saved: Dict[str, Any],
                            keys: Sequence[str] = MODEL_CONFIG_KEYS,
                            cli_args=None) -> None:
    """Copy the saved config's ``keys`` (by default the model-shape keys,
    ``MODEL_CONFIG_KEYS``) onto ``conf``: weights only load into the model
    shape that trained them. With ``cli_args``, a key the user set on the
    command line (not None there) keeps the command line's value."""
    for k in keys:
        if k not in saved or (cli_args is not None
                              and getattr(cli_args, k, None) is not None):
            continue
        if k in conf.__dataclass_fields__:
            setattr(conf, k, saved[k])
        else:
            conf.extra[k] = saved[k]


def restore(path: str, state) -> Dict[str, Any]:
    """Load a checkpoint into a ``TrainState``: the model's weights, the
    optimizer's state when the file has one, the step, and the STKIM
    generator's state and the EMA teacher's weights when both have one, so a
    resumed run draws at step t what an uninterrupted run draws there, with
    the same teacher. A file without a teacher (the reference's) leaves the
    state's teacher as it is. Returns the checkpoint dict (epoch, metrics,
    config)."""
    ckpt = load(path)
    state.model.load_state_dict(ckpt["model"])
    if state.teacher is not None and "teacher" in ckpt:
        state.teacher.load_state_dict(ckpt["teacher"])
    if ckpt.get("optimizer"):
        state.opt.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt.get("step", 0))
    if state.generator is not None and "generator" in ckpt:
        state.generator.set_state(ckpt["generator"])
    return ckpt


def save_best_and_last(ckpt_dir: str, state, epoch: int, conf,
                       val_metrics: Dict[str, float],
                       best: Dict[str, float],
                       write: bool = True) -> Dict[str, float]:
    """Apply the reference's selection rule (`Step3_ACMIL:156-170`): write
    ``checkpoint-best.pth`` when ``val_metrics`` beat ``best``, and
    ``checkpoint-last.pth`` always. Returns the updated best record. With
    ``write`` False (every rank of a mesh but global rank 0, whose states
    are the same) the record is kept and nothing is written."""
    from acmil_tpu_torch.engine.train import is_better

    kw = dict(epoch=epoch, conf=conf, optimizer=state.opt,
              metrics=val_metrics, step=state.step, generator=state.generator,
              teacher=state.teacher)
    if is_better(val_metrics, best,
                 str(getattr(conf, "selection_f1", "macro"))):
        best = dict(val_metrics)
        best["epoch"] = epoch
        if write:
            save(checkpoint_path(ckpt_dir, "best"), state.model, **kw)
    if write:
        save(checkpoint_path(ckpt_dir, "last"), state.model, **kw)
    return best
