"""MIL model dispatch, the port of ``acmil_tpu/models/__init__.py``.

A registry from arch name to ``(factory(conf) -> nn.Module, family)``,
where ``family`` keys into :mod:`acmil_tpu_torch.engine.families`. The
port registers ``ga`` (ACMIL_GA), ``mha`` (ACMIL_MHA), ``abmil``,
``mha_single`` (MHA), ``dsmil``, ``clam_sb`` and ``clam_mb`` (CLAM), and
the rest of the generic zoo: ``meanmil``, ``maxmil``, ``lbmil``,
``attmil``, ``attmil_gated``, ``ilra``, ``ips``, ``ibmil`` (phase 2 when the
config names ``c_path``), and ``bmil_vis``, ``bmil_enc`` and ``bmil_spvis``
(family ``bmil``), with the JAX registry's families. Every head draws its
initial weights from a ``torch.Generator`` seeded with ``conf.seed``.
``transmil``, ``dtfd``, ``mhim``/``pure`` and the rest of the JAX registry
raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from acmil_tpu_torch.models.acmil import ABMIL, ACMIL_GA, ACMIL_MHA, MHA
from acmil_tpu_torch.models.attmil import DAttentionMIL
from acmil_tpu_torch.models.bmil import BMILSpvis, BMILVis
from acmil_tpu_torch.models.clam import CLAM_MB, CLAM_SB
from acmil_tpu_torch.models.dsmil import DSMIL
from acmil_tpu_torch.models.ibmil import IBMIL
from acmil_tpu_torch.models.ilra import ILRA
from acmil_tpu_torch.models.ips import IPSNet
from acmil_tpu_torch.models.lbmil import LBMIL
from acmil_tpu_torch.models.mean_max import MaxMIL, MeanMIL

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


def _gen(conf) -> torch.Generator:
    return torch.Generator().manual_seed(int(conf.seed))


def _clam(cls, conf):
    # droprate configurable, so that `droprate: 0` takes the fused training
    # route (the reference default is dropout 0.25, `clam.py:86`); k_sample
    # and subtyping as the family reads them, so both routes agree
    return cls(n_class=conf.n_class, d_feat=conf.D_feat, d_inner=conf.D_inner,
               k_sample=int(getattr(conf, "k_sample", 8)),
               droprate=float(getattr(conf, "droprate", 0.25)),
               subtyping=getattr(conf, "subtyping", None),
               inst_loss=str(getattr(conf, "inst_loss", "ce")),
               generator=_gen(conf))


@register_model("clam_sb", family="clam")
def _clam_sb(conf):
    return _clam(CLAM_SB, conf)


@register_model("clam_mb", family="clam")
def _clam_mb(conf):
    return _clam(CLAM_MB, conf)


@register_model("meanmil")
def _mean(conf):
    return MeanMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                   d_inner=conf.D_inner, generator=_gen(conf))


@register_model("maxmil")
def _max(conf):
    return MaxMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                  d_inner=conf.D_inner, generator=_gen(conf))


@register_model("lbmil")
def _lbmil(conf):
    return LBMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, generator=_gen(conf))


@register_model("attmil")
def _attmil(conf):
    return DAttentionMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                         generator=_gen(conf))


@register_model("attmil_gated")
def _attmil_gated(conf):
    return DAttentionMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                         gated=True, generator=_gen(conf))


@register_model("ilra")
def _ilra(conf):
    return ILRA(n_class=conf.n_class, d_feat=conf.D_feat,
                generator=_gen(conf))


@register_model("ips")
def _ips(conf):
    return IPSNet(n_class=conf.n_class, d_feat=conf.D_feat,
                  d_inner=conf.D_inner,
                  m_keep=int(getattr(conf, "ips_m", 256)),
                  generator=_gen(conf))


def _confounders(conf):
    """The phase-2 dictionary ``[P, D_inner]`` from ``conf.c_path`` (one
    ``.npy`` path or a list, concatenated), or None (phase 1)."""
    c_path = getattr(conf, "c_path", None)
    if not c_path:
        return None
    paths = c_path if isinstance(c_path, (list, tuple)) else [c_path]
    return np.concatenate([np.load(p).reshape(-1, conf.D_inner)
                           for p in paths], 0).astype(np.float32)


@register_model("ibmil")
def _ibmil(conf):
    return IBMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, confounders=_confounders(conf),
                 confounder_merge=str(getattr(conf, "confounder_merge", "cat")),
                 confounder_learn=bool(getattr(conf, "c_learn", False)),
                 generator=_gen(conf))


@register_model("bmil_vis", family="bmil")
def _bmil_vis(conf):
    return BMILVis(n_class=conf.n_class, d_feat=conf.D_feat, with_kl=False,
                   generator=_gen(conf))


@register_model("bmil_enc", family="bmil")
def _bmil_enc(conf):
    return BMILVis(n_class=conf.n_class, d_feat=conf.D_feat, with_kl=True,
                   generator=_gen(conf))


@register_model("bmil_spvis", family="bmil")
def _bmil_spvis(conf):
    return BMILSpvis(n_class=conf.n_class, d_feat=conf.D_feat,
                     grid=int(getattr(conf, "bmil_grid", 64)),
                     generator=_gen(conf))


def build_mil_model(conf):
    """Returns (model, family) for ``conf.arch``."""
    if conf.arch not in _REGISTRY:
        raise ValueError(f"unknown arch {conf.arch!r}; have {sorted(_REGISTRY)}")
    factory, family = _REGISTRY[conf.arch]
    return factory(conf), family


__all__ = ["ABMIL", "ACMIL_GA", "ACMIL_MHA", "BMILSpvis", "BMILVis",
           "CLAM_MB", "CLAM_SB", "DAttentionMIL", "DSMIL", "IBMIL", "ILRA",
           "IPSNet", "LBMIL", "MHA", "MaxMIL", "MeanMIL", "build_mil_model",
           "register_model"]
