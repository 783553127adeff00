"""Per-architecture families, the port of ``acmil_tpu/engine/families.py``.

A family says how to run a model's deterministic forward and how to turn
its outputs into eval probabilities. The training side (losses, STKIM,
train forwards) comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.models.acmil import ACMIL_GA
from acmil_tpu_torch.models.fast import acmil_ga_apply_batched


class Family:
    """Default: the model returns slide logits."""

    name = "default"

    def eval_outputs(self, model, bag: Bag):
        return model(bag.feats, bag.mask, deterministic=True)

    def probs(self, outputs):
        if isinstance(outputs, dict):
            logits = outputs["logits"]
        elif isinstance(outputs, tuple):
            logits = outputs[1]  # (sub, slide, attn) convention
        else:
            logits = outputs
        return torch.softmax(logits, dim=-1)


class ACMILFamily(Family):
    """(sub, slide, attn) triple (`Step3_WSI_classification_ACMIL.py`).

    Eval of a GA-structured head runs the pooling through kernel B1
    (``models/fast.py::acmil_ga_apply_batched``); ``fused=False`` keeps the
    plain forward."""

    name = "acmil"

    def eval_outputs(self, model, bag: Bag, fused: bool = True):
        # eval is always deterministic (no STKIM, no dropout), so the fused
        # kernel is valid for every ACMIL_GA head
        if fused and isinstance(model, ACMIL_GA):
            return acmil_ga_apply_batched(model, bag.feats, bag.mask)
        return super().eval_outputs(model, bag)

    def probs(self, outputs):
        return torch.softmax(outputs[1], dim=-1)


FAMILIES: Dict[str, Family] = {"default": Family(), "acmil": ACMILFamily()}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
