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
from acmil_tpu_torch.models import fast
from acmil_tpu_torch.models.acmil import ACMIL_GA, ACMIL_MHA
from acmil_tpu_torch.models.bmil import kl_model
from acmil_tpu_torch.models.fast import acmil_ga_apply_batched
from acmil_tpu_torch.ops.masked import masked_max


class Family:
    """Default: the model returns slide logits; loss = CE. Every head of the
    family takes ``generator`` in its forward, the draws of its dropout in
    training; a head with no dropout, and ABMIL, MHA and DSMIL, whose
    dropout draws from torch's default generator, ignore it."""

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
        return model(bag.feats, bag.mask, deterministic=False,
                     generator=generator)

    def loss(self, outputs, bag: Bag, valid, conf_d):
        logits = outputs["logits"] if isinstance(outputs, dict) else outputs
        loss = L.cross_entropy(logits, bag.label, valid)
        return loss, {"ce_loss": loss}

    def plain_outputs(self, model, bag: Bag):
        """The model's own deterministic forward, no kernel route and
        nothing added: what Step4 reads the attention from."""
        return model(bag.feats, bag.mask, deterministic=True)

    def eval_outputs(self, model, bag: Bag):
        return self.plain_outputs(model, bag)

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
    B1 unless ``fused=False``. An ACMIL_MHA head runs its plain forward,
    as in the JAX package, with STKIM inside each branch's logits and
    ``[B, H, K, N]`` attention for the diversity loss. STKIM's uniforms
    come from ``stkim_u`` when given, else from ``generator``."""

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
        if isinstance(model, (ACMIL_GA, ACMIL_MHA)):
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


class CLAMFamily(Family):
    """Bag CE mixed with the instance clustering loss (`engine.py:99-116`:
    ``w_loss * bag + (1 - w_loss) * instance``); the model needs the labels
    for its in/out-of-class instance supervision.

    CLAM's ``Attn_Net_Gated`` is the gated attention kernels B1 and B2
    compute, so a bag whose padded length reaches ``fast.FUSE_MIN_N`` runs
    ``fast.clam_apply_fused``: in eval always (dropout is off there), in
    training when ``droprate`` is 0 and the instance loss is CE (the
    reference default trains with dropout 0.25, which keeps the plain
    forward, its dropout drawn from ``generator``). ``fused_train: false``
    keeps the plain forward in training, and ``fused=False`` in eval."""

    name = "clam"

    def conf_dict(self, conf):
        d = super().conf_dict(conf)
        d["fused"] = (bool(conf.extra.get("fused_train", True))
                      and float(getattr(conf, "droprate", 0.25)) == 0.0
                      and str(getattr(conf, "inst_loss", "ce")) == "ce")
        d["k_sample"] = int(getattr(conf, "k_sample", 8))
        sub = getattr(conf, "subtyping", None)
        d["subtyping"] = (conf.n_class > 2) if sub is None else bool(sub)
        return d

    @staticmethod
    def _routed(model, bag) -> bool:
        return (fast.clam_is_fusable(model)
                and bag.feats.shape[1] >= fast.FUSE_MIN_N)

    def train_outputs(self, model, bag, conf_d, stkim_u=None, generator=None):
        if conf_d.get("fused") and self._routed(model, bag):
            return fast.clam_apply_fused(
                model, bag.feats, bag.mask, label=bag.label,
                instance_eval=True, n_class=conf_d["n_class"],
                k_sample=conf_d["k_sample"], subtyping=conf_d["subtyping"])
        return model(bag.feats, bag.mask, label=bag.label, instance_eval=True,
                     deterministic=False, generator=generator)

    def eval_outputs(self, model, bag: Bag, fused: bool = True):
        if fused and self._routed(model, bag):
            return fast.clam_apply_fused(model, bag.feats, bag.mask,
                                         n_class=0)
        return super().eval_outputs(model, bag)

    def loss(self, outputs, bag, valid, conf_d):
        logits, inst_loss = outputs["logits"], outputs["instance_loss"]
        bag_loss = L.cross_entropy(logits, bag.label, valid)
        w = conf_d["w_loss"]
        return w * bag_loss + (1 - w) * inst_loss, {
            "bag_loss": bag_loss, "instance_loss": inst_loss}


class DSMILFamily(Family):
    """(inst_logits, bag_logits, attn): 0.5 CE(masked-max inst) + 0.5 CE(bag)
    (`engine.py:41-56`); eval probs = mean of the two softmaxes
    (`engine.py:176-182`). Training runs the plain forward with autograd, as
    in the JAX package. Eval of the generic trainer's build pools through
    kernel B6 (``fast.dsmil_eval_fused``) when the bag's padded length is at
    least ``fast.FUSE_MIN_N``, the JAX package's route; below it, or with
    ``fused=False``, the plain forward runs."""

    name = "dsmil"

    def _max_inst(self, outputs, bag):
        inst, bag_logits, _ = outputs
        return masked_max(inst, bag.mask, dim=1), bag_logits

    def loss(self, outputs, bag, valid, conf_d):
        max_preds, bag_logits = self._max_inst(outputs, bag)
        ce = 0.5 * L.cross_entropy(max_preds, bag.label, valid) \
            + 0.5 * L.cross_entropy(bag_logits, bag.label, valid)
        # the reference adds w_loss * pairwise attention diversity when
        # n_token > 1 (`engine.py:50-58`)
        n_tok = min(conf_d["n_token"], outputs[2].shape[1])
        div = L.attention_diversity_loss(outputs[2][:, :n_tok], bag.mask,
                                         n_tok, valid)
        loss = ce + conf_d["w_loss"] * div
        return loss, {"ce_loss": ce, "diff_loss": div}

    def eval_outputs(self, model, bag: Bag, fused: bool = True):
        if (fused and fast.dsmil_is_fusable(model)
                and bag.feats.shape[1] >= fast.FUSE_MIN_N):
            return fast.dsmil_eval_fused(model, bag.feats, bag.mask)
        return self._max_inst(self.plain_outputs(model, bag), bag)

    def probs(self, outputs):
        max_preds, bag_logits = outputs
        return 0.5 * torch.softmax(max_preds, dim=-1) \
            + 0.5 * torch.softmax(bag_logits, dim=-1)


class BMILFamily(Family):
    """CE + 1e-8 · model ARD KL + 1e-6 · data KL (`engine.py:74-96`). The
    data KL comes back in the output dict; the model's (ARD) KL is every
    ``LinearVDO`` child's summed (``models/bmil.py::kl_model``), where the
    JAX family sums the sown ``kl`` collection. Training passes ``coords``
    and ``label``, eval ``coords`` only, as in the JAX family; the noise
    comes from ``generator``."""

    name = "bmil"

    @staticmethod
    def _with_kl_model(model, out):
        out = dict(out)
        out["kl_model"] = kl_model(model)
        return out

    def train_outputs(self, model, bag, conf_d, stkim_u=None, generator=None):
        return self._with_kl_model(model, model(
            bag.feats, bag.mask, coords=bag.coords, label=bag.label,
            deterministic=False, generator=generator))

    def loss(self, outputs, bag, valid, conf_d):
        ce = L.cross_entropy(outputs["logits"], bag.label, valid)
        loss = ce + 1e-8 * outputs["kl_model"] + 1e-6 * outputs["kl_data"]
        return loss, {"ce_loss": ce, "kl_model": outputs["kl_model"],
                      "kl_data": outputs["kl_data"]}

    def plain_outputs(self, model, bag: Bag):
        return model(bag.feats, bag.mask, coords=bag.coords,
                     deterministic=True)

    def eval_outputs(self, model, bag: Bag):
        return self._with_kl_model(model, self.plain_outputs(model, bag))


FAMILIES: Dict[str, Family] = {"default": Family(), "acmil": ACMILFamily(),
                               "clam": CLAMFamily(), "dsmil": DSMILFamily(),
                               "bmil": BMILFamily()}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
