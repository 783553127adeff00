"""MIL model dispatch, the port of ``acmil_tpu/models/__init__.py``.

A registry from arch name to ``(factory(conf) -> nn.Module, family)``,
where ``family`` keys into :mod:`acmil_tpu_torch.engine.families`. The
port registers ``ga`` (ACMIL_GA), ``mha`` (ACMIL_MHA), ``abmil``,
``mha_single`` (MHA), ``dsmil``, and ``clam_sb`` and ``clam_mb`` (CLAM).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from acmil_tpu_torch.models.acmil import ABMIL, ACMIL_GA, ACMIL_MHA, MHA
from acmil_tpu_torch.models.clam import CLAM_MB, CLAM_SB
from acmil_tpu_torch.models.dsmil import DSMIL

_REGISTRY: Dict[str, Tuple[Callable, str]] = {}


def register_model(name: str, family: str = "default"):
    def deco(factory):
        _REGISTRY[name] = (factory, family)
        return factory

    return deco


@register_model("abmil")
def _abmil(conf):
    return ABMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner)


@register_model("mha_single")
def _mha(conf):
    return MHA(n_class=conf.n_class, d_feat=conf.D_feat, d_inner=conf.D_inner)


@register_model("ga", family="acmil")
def _acmil_ga(conf):
    return ACMIL_GA(
        n_class=conf.n_class,
        d_feat=conf.D_feat,
        d_inner=conf.D_inner,
        n_token=conf.n_token,
        n_masked_patch=conf.n_masked_patch,
        mask_drop=conf.mask_drop,
    )


@register_model("mha", family="acmil")
def _acmil_mha(conf):
    return ACMIL_MHA(
        n_class=conf.n_class,
        d_feat=conf.D_feat,
        d_inner=conf.D_inner,
        n_token=conf.n_token,
        n_masked_patch=conf.n_masked_patch,
        mask_drop=conf.mask_drop,
    )


@register_model("dsmil", family="dsmil")
def _dsmil(conf):
    # the generic trainer builds BClassifier(nonlinear=False)
    # (Step3_WSI_classification.py:129-131)
    return DSMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, nonlinear=False)


def _clam(cls, conf):
    # droprate configurable, so that `droprate: 0` takes the fused training
    # route (the reference default is dropout 0.25, `clam.py:86`); k_sample
    # and subtyping as the family reads them, so both routes agree
    return cls(n_class=conf.n_class, d_feat=conf.D_feat, d_inner=conf.D_inner,
               k_sample=int(getattr(conf, "k_sample", 8)),
               droprate=float(getattr(conf, "droprate", 0.25)),
               subtyping=getattr(conf, "subtyping", None),
               inst_loss=str(getattr(conf, "inst_loss", "ce")),
               generator=torch.Generator().manual_seed(int(conf.seed)))


@register_model("clam_sb", family="clam")
def _clam_sb(conf):
    return _clam(CLAM_SB, conf)


@register_model("clam_mb", family="clam")
def _clam_mb(conf):
    return _clam(CLAM_MB, conf)


def build_mil_model(conf):
    """Returns (model, family) for ``conf.arch``."""
    if conf.arch not in _REGISTRY:
        raise ValueError(f"unknown arch {conf.arch!r}; have {sorted(_REGISTRY)}")
    factory, family = _REGISTRY[conf.arch]
    return factory(conf), family


__all__ = ["ABMIL", "ACMIL_GA", "ACMIL_MHA", "CLAM_MB", "CLAM_SB", "DSMIL",
           "MHA", "build_mil_model", "register_model"]
