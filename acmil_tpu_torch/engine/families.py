"""Per-architecture families, the port of ``acmil_tpu/engine/families.py``.

A family says how to run a model's training forward, how to turn its outputs
into a loss, and how to run its deterministic forward and turn that into eval
probabilities.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import losses as L
from acmil_tpu_torch.models.acmil import ACMIL_GA
from acmil_tpu_torch.models.fast import acmil_ga_apply_batched


class Family:
    """Default: the model returns slide logits; loss = CE."""

    name = "default"

    def conf_dict(self, conf) -> Dict[str, Any]:
        return {
            "n_token": getattr(conf, "n_token", 1),
            "n_class": conf.n_class,
            "w_loss": float(getattr(conf, "w_loss", 0.7)),
        }

    def train_outputs(self, model, bag: Bag, conf_d,
                      stkim_u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        return model(bag.feats, bag.mask, deterministic=False)

    def loss(self, outputs, bag: Bag, valid, conf_d):
        logits = outputs["logits"] if isinstance(outputs, dict) else outputs
        loss = L.cross_entropy(logits, bag.label, valid)
        return loss, {"ce_loss": loss}

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
    """(sub, slide, attn) triple; branch CE + slide CE + diversity
    (`Step3_WSI_classification_ACMIL.py:199-216`).

    With ``fused_train`` on (the default), an ACMIL_GA head trains through
    kernels B1 and B2 (``models/fast.py::acmil_ga_apply_batched``), STKIM
    as an O(K·k) correction on the pooled output; ``fused_train: false`` or
    ``droprate > 0`` keeps the plain forward. Eval of an ACMIL_GA head runs
    B1 unless ``fused=False``. STKIM's uniforms come from ``stkim_u`` when
    given, else from ``generator``."""

    name = "acmil"

    def conf_dict(self, conf):
        d = super().conf_dict(conf)
        d["fused"] = (bool(conf.extra.get("fused_train", True))
                      and float(conf.extra.get("droprate", 0.0)) == 0.0)
        d["n_masked_patch"] = int(getattr(conf, "n_masked_patch", 0))
        d["mask_drop"] = float(getattr(conf, "mask_drop", 0.0))
        return d

    def train_outputs(self, model, bag, conf_d, stkim_u=None, generator=None):
        if conf_d.get("fused", False) and isinstance(model, ACMIL_GA):
            return acmil_ga_apply_batched(
                model, bag.feats, bag.mask, stkim_u=stkim_u,
                stkim_generator=generator,
                n_masked_patch=conf_d["n_masked_patch"],
                mask_drop=conf_d["mask_drop"])
        if isinstance(model, ACMIL_GA):
            return model(bag.feats, bag.mask, deterministic=False,
                         stkim_u=stkim_u, stkim_generator=generator)
        return super().train_outputs(model, bag, conf_d)

    def eval_outputs(self, model, bag: Bag, fused: bool = True):
        # eval is always deterministic (no STKIM, no dropout), so the fused
        # kernel is valid for every ACMIL_GA head
        if fused and isinstance(model, ACMIL_GA):
            return acmil_ga_apply_batched(model, bag.feats, bag.mask)
        return super().eval_outputs(model, bag)

    def loss(self, outputs, bag, valid, conf_d):
        sub, slide, attn = outputs
        return L.acmil_loss(sub, slide, attn, bag.label, bag.mask,
                            conf_d["n_token"], valid)

    def probs(self, outputs):
        return torch.softmax(outputs[1], dim=-1)


FAMILIES: Dict[str, Family] = {"default": Family(), "acmil": ACMILFamily()}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
