"""MIL model dispatch, the port of ``acmil_tpu/models/__init__.py``.

A registry from arch name to ``(factory(conf) -> nn.Module, family)``,
where ``family`` keys into :mod:`acmil_tpu_torch.engine.families`. The
port registers ``ga`` (ACMIL_GA), ``mha`` (ACMIL_MHA), ``abmil``,
``mha_single`` (MHA) and ``dsmil``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from acmil_tpu_torch.models.acmil import ABMIL, ACMIL_GA, ACMIL_MHA, MHA
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


def build_mil_model(conf):
    """Returns (model, family) for ``conf.arch``."""
    if conf.arch not in _REGISTRY:
        raise ValueError(f"unknown arch {conf.arch!r}; have {sorted(_REGISTRY)}")
    factory, family = _REGISTRY[conf.arch]
    return factory(conf), family


__all__ = ["ABMIL", "ACMIL_GA", "ACMIL_MHA", "DSMIL", "MHA", "build_mil_model",
           "register_model"]
