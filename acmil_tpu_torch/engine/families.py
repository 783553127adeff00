"""Per-architecture families, the port of ``acmil_tpu/engine/families.py``.

A family says how to run a model's training forward, how to turn its outputs
into a loss, and how to run its deterministic forward and turn that into eval
probabilities. A family may also bring its own optimizer (``make_optimizer``,
the JAX ``make_tx``) and name the parameter groups it clips each by its own
norm (``clip_groups``), keep an EMA teacher in the train state (``teacher``)
and bring its own train step (``make_step``, the JAX ``make_step_body``):
MHIM does three, its 'pure' stage the first, and DTFD the first two.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import losses as L
from acmil_tpu_torch.models import fast
from acmil_tpu_torch.models.acmil import ACMIL_GA, ACMIL_MHA
from acmil_tpu_torch.models.bmil import kl_model
from acmil_tpu_torch.models.fast import acmil_ga_apply_batched
from acmil_tpu_torch.models.mhim import soft_target_ce
from acmil_tpu_torch.ops.masked import masked_max


class Family:
    """Default: the model returns slide logits; loss = CE. Every head of the
    family takes ``generator`` in its forward, the draws of its dropout in
    training; a head with no dropout, and ABMIL, MHA and DSMIL, whose
    dropout draws from torch's default generator, ignore it."""

    name = "default"
    # True: the train state keeps an EMA teacher, a copy of the model
    teacher = False

    def make_optimizer(self, params, conf, lr: float,
                       device: torch.device) -> Optional[torch.optim.Optimizer]:
        """The family's whole optimizer at learning rate ``lr`` (the trainer
        sets each step's rate from the schedule), or None for the trainer's
        AdamW with its global-norm clip."""
        return None

    def clip_groups(self, model, conf):
        """``(max_norm, [[param, ...], ...])``: each group clipped by its own
        norm before the family's optimizer steps, or None for no clip."""
        return None

    def make_step(self, model, conf):
        """The family's own ``step(state, bag, stkim_u=None) -> aux``, or
        None for the trainer's."""
        return None

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


def mhim_script_optimizer(params, conf, lr: float,
                          device: torch.device) -> torch.optim.Optimizer:
    """The MHIM script's optimizer (`Step3_MHIM:380`): plain
    ``torch.optim.Adam(lr, weight_decay=wd)``, whose decay is coupled (added
    to the gradient before the moments, as ``optax.add_decayed_weights``
    then ``adam``), and no gradient clipping even when ``grad_clipping`` is
    set (the script defines the flag and never applies it)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=float(conf.wd),
                            fused=True if device.type == "cuda" else None)


class DTFDFamily(Family):
    """Tier-1 CE over every valid pseudo-bag's logits (``loss0``) plus the
    tier-2 CE (``loss1``), `Step3_DTFD:131-148`; eval probabilities are the
    tier-2 softmax. The reference's two ``torch.optim.Adam(weight_decay=wd)``
    are one coupled-L2 Adam over the union (:func:`mhim_script_optimizer`),
    and its per-module ``clip_grad_norm_`` clips ``dimReduction``,
    ``attention``, ``classifier`` and ``UClassifier`` each by its own norm
    (``grad_clipping``, 5.0 when unset, 0 for none). The two losses reach
    disjoint parameters, so clipping their joint gradient per module is the
    reference's per-loss clip.

    The pseudo-bags pool through kernels B1 and B2
    (``fast.dtfd_apply_fused``) when ``fused_train`` is on (the default),
    ``droprate`` is 0 and the per-group length reaches
    ``fast.DTFD_FUSE_MIN_S``; eval takes the kernels at any droprate, since
    dropout is off there. The grouping's uniforms are ``stkim_u [B, N]``
    when given, else drawn from ``generator``."""

    name = "dtfd"

    def conf_dict(self, conf):
        d = super().conf_dict(conf)
        num_group = int(getattr(conf, "numGroup", 4))
        d["num_group"] = num_group
        d["instance_per_group"] = max(
            1, int(getattr(conf, "total_instance", 4)) // num_group)
        d["distill"] = str(getattr(conf, "distill", "MaxMinS"))
        d["fused"] = bool(conf.extra.get("fused_train", True))
        d["droprate"] = float(getattr(conf, "droprate", 0.0))
        return d

    @staticmethod
    def _routed(model, bag) -> bool:
        n, g = bag.feats.shape[1], model.num_group
        return (fast.DTFD_FUSE_MIN_S is not None and n % g == 0
                and n // g >= fast.DTFD_FUSE_MIN_S)

    def train_outputs(self, model, bag, conf_d, stkim_u=None, generator=None):
        if (conf_d["fused"] and conf_d["droprate"] == 0.0
                and self._routed(model, bag)):
            return fast.dtfd_apply_fused(model, bag.feats, bag.mask,
                                         deterministic=False, group_u=stkim_u,
                                         generator=generator)
        return model(bag.feats, bag.mask, deterministic=False,
                     group_u=stkim_u, generator=generator)

    def eval_outputs(self, model, bag: Bag, fused: bool = True):
        if fused and self._routed(model, bag):
            return fast.dtfd_apply_fused(model, bag.feats, bag.mask)
        return super().eval_outputs(model, bag)

    def loss(self, outputs, bag, valid, conf_d):
        sub = outputs["sub_preds"]                               # [B, G, C]
        b, g, c = sub.shape
        gvalid = outputs["group_valid"] & valid[:, None]
        loss0 = L.cross_entropy(sub.reshape(b * g, c),
                                bag.label.repeat_interleave(g),
                                gvalid.reshape(b * g))
        loss1 = L.cross_entropy(outputs["logits"], bag.label, valid)
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}

    def make_optimizer(self, params, conf, lr, device):
        return mhim_script_optimizer(params, conf, lr, device)

    def clip_groups(self, model, conf):
        raw = getattr(conf, "grad_clipping", None)
        clip = 5.0 if raw is None else float(raw)   # the reference CLI's
        if not clip:
            return None
        return clip, [list(getattr(model, name).parameters()) for name in
                      ("dimReduction", "attention", "classifier",
                       "UClassifier")]


class PureFamily(Family):
    """The MHIM script's ``--model pure`` stage (`Step3_MHIM:312-314`): the
    default family's CE training through the script's coupled-L2 Adam."""

    name = "pure"

    def make_optimizer(self, params, conf, lr, device):
        return mhim_script_optimizer(params, conf, lr, device)


class MHIMFamily(PureFamily):
    """The teacher-EMA step (`Step3_MHIM:124-161`): the teacher's forward
    (no grad, deterministic, with its attention), the student's with masks
    composed from that attention and the scheduled ``mask_ratio_h``, loss =
    ``cls_alpha`` CE + ``cl_alpha`` soft-target CE (student cls feature
    against the teacher's, temperatures ``temp_t`` 0.1 and ``temp_s`` 1.0),
    the Adam step, then the EMA ``t <- t·mm + s·(1 - mm)`` in float32 over
    every parameter. ``mm`` and the mask ratio follow the reference's cosine
    arrays when ``mm_sche``/``mrh_sche`` are set, indexed by the step and
    clamped to the array's end."""

    name = "mhim"
    teacher = True

    def make_step(self, model, conf):
        from acmil_tpu_torch.engine.schedules import cosine_array
        from acmil_tpu_torch.engine.train import apply_gradients

        cls_alpha = float(getattr(conf, "cls_alpha", 1.0))
        cl_alpha = float(getattr(conf, "cl_alpha", 0.1))
        # the reference CLI's temperatures (`Step3_MHIM:72`), not the
        # module's defaults
        temp_t = float(getattr(conf, "temp_t", 0.1))
        temp_s = float(getattr(conf, "temp_s", 1.0))
        mm0 = float(getattr(conf, "mm", 0.9999))
        per_epoch = max(int(getattr(conf, "steps_per_epoch", 1)), 1)

        def array(base, final):
            return cosine_array(base, final, conf.train_epoch,
                                per_epoch).astype(np.float32)

        mm_arr = (array(mm0, float(getattr(conf, "mm_final", 1.0)))
                  if bool(getattr(conf, "mm_sche", False)) else None)
        mrh_arr = (array(float(getattr(conf, "mask_ratio_h", 0.0)), 0.0)
                   if bool(getattr(conf, "mrh_sche", False)) else None)
        params = [p for p in model.parameters() if p.requires_grad]

        def step(state, bag, stkim_u=None) -> Dict[str, torch.Tensor]:
            """``stkim_u [2, B, N]``: the student's mask uniforms (random
            masking, then the high-attention subset); drawn from
            ``state.generator`` when None."""
            if state.teacher is None:
                raise ValueError("the mhim family needs a train state with "
                                 "a teacher: create_train_state(..., "
                                 "family='mhim')")
            if mm_arr is not None:
                mm = mm_arr[min(state.step, len(mm_arr) - 1)]
                one_minus = np.float32(1.0) - mm
            else:
                mm, one_minus = np.float32(mm0), np.float32(1.0 - mm0)
            mrh = None
            if mrh_arr is not None:
                mrh = torch.tensor(mrh_arr[min(state.step, len(mrh_arr) - 1)],
                                   device=bag.feats.device)
            valid = bag.mask.any(dim=1)
            with torch.no_grad():
                tea = state.teacher.eval()(bag.feats, bag.mask,
                                           deterministic=True,
                                           return_attn=True)
            model.train()
            out = model(bag.feats, bag.mask, deterministic=False,
                        teacher_attn=tea["attn"], mask_ratio_h=mrh,
                        generator=state.generator, mask_u=stkim_u)
            ce = L.cross_entropy(out["logits"], bag.label, valid)
            cl = (soft_target_ce(out["cls_feat"], tea["cls_feat"], temp_t,
                                 temp_s) if cl_alpha > 0
                  else torch.zeros((), device=ce.device))
            loss = cls_alpha * ce + cl_alpha * cl
            norm = apply_gradients(state, loss, params)
            with torch.no_grad():
                tp = list(state.teacher.parameters())
                torch._foreach_mul_(tp, float(mm))
                torch._foreach_add_(tp, torch._foreach_mul(
                    list(model.parameters()), float(one_minus)))
            return {"logit_loss": ce.detach(), "cls_loss": cl.detach(),
                    "loss": loss.detach(), "grad_norm": norm}

        return step


FAMILIES: Dict[str, Family] = {"default": Family(), "acmil": ACMILFamily(),
                               "clam": CLAMFamily(), "dsmil": DSMILFamily(),
                               "bmil": BMILFamily(), "dtfd": DTFDFamily(),
                               "pure": PureFamily(),
                               "mhim": MHIMFamily()}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
